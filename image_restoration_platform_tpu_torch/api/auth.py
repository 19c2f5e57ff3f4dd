"""JWT/JWKS bearer-token verification.

The reference verifies real Firebase ID tokens with a lazily-initialized
admin SDK and falls back to ``dev-user-<id>`` mock tokens when credentials
are absent (firebaseAuth.js:7-55). This is the real-identity adapter for our
stack: standard JWS compact tokens (RS256/ES256) verified against a JWKS
document — which covers Firebase ID tokens too, since those are RS256 JWTs
against Google's published JWKS.

Configuration (all optional; with none set the mock scheme applies):
  AUTH_JWKS_PATH   path to a local JWKS JSON file
  AUTH_JWKS_URL    https URL to fetch the JWKS from (cached, TTL below)
  AUTH_ISSUER      required ``iss`` claim when set
  AUTH_AUDIENCE    required ``aud`` claim when set
  AUTH_ALLOW_MOCK  "1" keeps accepting dev-user-<id> tokens alongside JWTs
"""

from __future__ import annotations

import base64
import json
import os
import time

from ..utils.logging import get_logger

_log = get_logger("auth")

JWKS_CACHE_TTL_S = 300.0


def _b64url_decode(data: str) -> bytes:
    padded = data + "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(padded)


def _b64url_to_int(data: str) -> int:
    return int.from_bytes(_b64url_decode(data), "big")


class JwtError(Exception):
    pass


def _public_key_from_jwk(jwk: dict):
    from cryptography.hazmat.primitives.asymmetric import ec, rsa

    kty = jwk.get("kty")
    if kty == "RSA":
        return rsa.RSAPublicNumbers(
            _b64url_to_int(jwk["e"]), _b64url_to_int(jwk["n"])
        ).public_key()
    if kty == "EC" and jwk.get("crv") == "P-256":
        return ec.EllipticCurvePublicNumbers(
            _b64url_to_int(jwk["x"]), _b64url_to_int(jwk["y"]), ec.SECP256R1()
        ).public_key()
    raise JwtError(f"unsupported JWK key type {kty!r}")


def _verify_signature(alg: str, key, signing_input: bytes, signature: bytes) -> None:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec, padding, utils

    try:
        if alg == "RS256":
            key.verify(signature, signing_input, padding.PKCS1v15(), hashes.SHA256())
        elif alg == "ES256":
            # JWS ES256 signatures are raw r||s (RFC 7518 §3.4), not DER
            if len(signature) != 64:
                raise JwtError("malformed ES256 signature")
            r = int.from_bytes(signature[:32], "big")
            s = int.from_bytes(signature[32:], "big")
            der = utils.encode_dss_signature(r, s)
            key.verify(der, signing_input, ec.ECDSA(hashes.SHA256()))
        else:
            raise JwtError(f"unsupported alg {alg!r}")
    except InvalidSignature:
        raise JwtError("signature verification failed")


class JwksVerifier:
    """Callable ``verifier(token) -> user dict | None`` for the auth
    middleware (api/middleware.py): JWS verification + iss/aud/exp/nbf claim
    checks with leeway, key lookup by ``kid`` with JWKS refresh on miss."""

    def __init__(
        self,
        jwks: dict | None = None,
        *,
        jwks_path: str | None = None,
        jwks_url: str | None = None,
        issuer: str | None = None,
        audience: str | None = None,
        leeway_s: float = 60.0,
        allow_mock: bool = False,
        clock=time.time,
    ):
        self._jwks_path = jwks_path
        self._jwks_url = jwks_url
        self._issuer = issuer
        self._audience = audience
        self._leeway = leeway_s
        self._allow_mock = allow_mock
        self._clock = clock
        self._keys: dict[str, dict] = {}
        self._fetched_at = 0.0
        if jwks:
            self._install(jwks)

    # ---- JWKS management

    def _install(self, jwks: dict) -> None:
        self._keys = {k.get("kid", ""): k for k in jwks.get("keys", [])}
        self._fetched_at = self._clock()

    def _refresh(self, force: bool = False) -> None:
        if not force and self._keys and self._clock() - self._fetched_at < JWKS_CACHE_TTL_S:
            return
        try:
            if self._jwks_path:
                with open(self._jwks_path) as fh:
                    self._install(json.load(fh))
            elif self._jwks_url:
                import urllib.request

                with urllib.request.urlopen(self._jwks_url, timeout=5) as resp:
                    self._install(json.loads(resp.read()))
        except Exception as error:
            _log.error("JWKS refresh failed", {"error": str(error)})

    def _key_for(self, kid: str | None) -> dict | None:
        self._refresh()
        if kid is None:
            # single-key JWKS may omit kid on both sides
            return next(iter(self._keys.values()), None) if len(self._keys) == 1 else None
        if kid not in self._keys:
            self._refresh(force=True)
        return self._keys.get(kid)

    # ---- verification

    def verify(self, token: str) -> dict:
        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
        except ValueError:
            raise JwtError("not a JWS compact token")
        try:
            header = json.loads(_b64url_decode(header_b64))
            claims = json.loads(_b64url_decode(payload_b64))
            signature = _b64url_decode(sig_b64)
        except (ValueError, json.JSONDecodeError):
            raise JwtError("malformed token segments")

        alg = header.get("alg")
        if alg not in ("RS256", "ES256"):
            raise JwtError(f"disallowed alg {alg!r}")
        jwk = self._key_for(header.get("kid"))
        if jwk is None:
            raise JwtError("no matching JWKS key")
        key = _public_key_from_jwk(jwk)
        _verify_signature(alg, key, f"{header_b64}.{payload_b64}".encode(), signature)

        now = self._clock()
        if "exp" in claims and now > float(claims["exp"]) + self._leeway:
            raise JwtError("token expired")
        if "nbf" in claims and now < float(claims["nbf"]) - self._leeway:
            raise JwtError("token not yet valid")
        if self._issuer and claims.get("iss") != self._issuer:
            raise JwtError("issuer mismatch")
        if self._audience:
            aud = claims.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if self._audience not in auds:
                raise JwtError("audience mismatch")
        if not claims.get("sub"):
            raise JwtError("missing sub claim")
        return claims

    def __call__(self, token: str) -> dict | None:
        if self._allow_mock and token.startswith("dev-user-"):
            user_id = token.split("-", 2)[2] or "mock-user"
            return {"id": user_id, "email": f"{user_id}@example.dev", "tokenSource": "mock"}
        try:
            claims = self.verify(token)
        except JwtError:
            return None
        return {
            "id": claims["sub"],
            "email": claims.get("email"),
            "name": claims.get("name"),
            "claims": claims,
            "tokenSource": "jwt",
        }


def create_verifier_from_env():
    """Verifier from AUTH_* env; None when no JWKS source is configured (the
    middleware then applies the dev mock scheme, firebaseAuth.js:43-55)."""
    jwks_path = os.environ.get("AUTH_JWKS_PATH")
    jwks_url = os.environ.get("AUTH_JWKS_URL")
    if not jwks_path and not jwks_url:
        return None
    return JwksVerifier(
        jwks_path=jwks_path,
        jwks_url=jwks_url,
        issuer=os.environ.get("AUTH_ISSUER"),
        audience=os.environ.get("AUTH_AUDIENCE"),
        allow_mock=os.environ.get("AUTH_ALLOW_MOCK") == "1",
    )
