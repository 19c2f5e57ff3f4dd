"""Google Vision SafeSearch adapter for the moderation service.

The reference constructs a real SafeSearch client from credentials and falls
back to the deterministic mock when absent (context/services.js:15-40,
services/moderation.js:157-179). This is the concrete adapter for our stack:
a ``vision_client(image_bytes) -> flags`` callable over the Vision REST API
(``images:annotate`` with SAFE_SEARCH_DETECTION), authenticated by either an
API key (VISION_API_KEY) or a bearer token (VISION_ACCESS_TOKEN — e.g. from
workload identity / metadata server tooling). Errors propagate so
ModerationService applies its fail-closed policy.

The HTTP transport is injectable for tests and air-gapped environments.
"""

from __future__ import annotations

import base64
import json
import os
import urllib.request
from typing import Callable

from ..utils.logging import get_logger

_log = get_logger("vision")

VISION_ENDPOINT = "https://vision.googleapis.com/v1/images:annotate"
FLAG_KEYS = ("adult", "violence", "racy", "spoof", "medical")


def _default_transport(url: str, body: bytes, headers: dict) -> dict:
    request = urllib.request.Request(url, data=body, headers=headers, method="POST")
    with urllib.request.urlopen(request, timeout=10) as resp:
        return json.loads(resp.read())


class VisionSafeSearchClient:
    """Callable: image bytes -> SafeSearch flags dict (UNKNOWN..VERY_LIKELY)."""

    def __init__(
        self,
        api_key: str | None = None,
        access_token: str | None = None,
        endpoint: str = VISION_ENDPOINT,
        transport: Callable[[str, bytes, dict], dict] | None = None,
    ):
        if not api_key and not access_token and transport is None:
            raise ValueError("VisionSafeSearchClient needs an api_key, access_token, or transport")
        self.api_key = api_key
        self.access_token = access_token
        self.endpoint = endpoint
        self.transport = transport or _default_transport

    def __call__(self, image_bytes: bytes) -> dict:
        url = self.endpoint
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            url = f"{url}?key={self.api_key}"
        elif self.access_token:
            headers["Authorization"] = f"Bearer {self.access_token}"
        body = json.dumps(
            {
                "requests": [
                    {
                        "image": {"content": base64.b64encode(image_bytes).decode("ascii")},
                        "features": [{"type": "SAFE_SEARCH_DETECTION"}],
                    }
                ]
            }
        ).encode()
        payload = self.transport(url, body, headers)
        responses = payload.get("responses") or []
        if not responses:
            raise RuntimeError("Vision API returned no responses")
        first = responses[0]
        if "error" in first:
            raise RuntimeError(f"Vision API error: {first['error'].get('message', 'unknown')}")
        annotation = first.get("safeSearchAnnotation") or {}
        return {k: str(annotation.get(k, "UNKNOWN")).upper() for k in FLAG_KEYS}


def create_vision_client(transport=None):
    """Vision client from env (VISION_API_KEY / VISION_ACCESS_TOKEN); None
    when unconfigured so ModerationService falls back to the deterministic
    mock — the reference's exact degradation ladder."""
    api_key = os.environ.get("VISION_API_KEY")
    token = os.environ.get("VISION_ACCESS_TOKEN")
    if not api_key and not token and transport is None:
        return None
    _log.info("Vision SafeSearch adapter configured", {"auth": "api-key" if api_key else "bearer"})
    return VisionSafeSearchClient(api_key=api_key, access_token=token, transport=transport)
