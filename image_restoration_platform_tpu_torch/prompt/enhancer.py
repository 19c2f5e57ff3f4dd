"""Meta-prompt text from degradation scores.

The port's copy of the template text and selection logic of
image_restoration_platform_tpu/prompt/enhancer.py (``PromptEnhancerService
.enhance``): issues are the scores above 0.3, ranked by confidence, top 3
kept; severity high >= 0.7 / medium >= 0.5 / low; each (type, severity)
maps to a fixed instruction phrase. The model's conditioning is built on
the device from the same scores (classify/fused.py); the text is kept for
API parity.
"""

from __future__ import annotations

from ..obs.tracing import get_tracer
from ..utils.logging import get_logger

DEGRADATION_TEMPLATES = {
    "blur": {
        "high": "reduce severe motion blur and sharpen edges while preserving natural detail",
        "medium": "reduce motion blur and improve focus clarity",
        "low": "slightly enhance sharpness and edge definition",
    },
    "noise": {
        "high": "aggressively suppress grain and noise while preserving fine detail and texture",
        "medium": "reduce noise and grain while maintaining image detail",
        "low": "lightly reduce noise without affecting texture",
    },
    "lowLight": {
        "high": "significantly enhance brightness and recover shadow detail without overexposure",
        "medium": "improve brightness and enhance shadow areas",
        "low": "slightly brighten dark areas and improve visibility",
    },
    "compression": {
        "high": "remove severe JPEG artifacts and restore texture quality",
        "medium": "reduce compression artifacts and improve image quality",
        "low": "minimize minor compression artifacts",
    },
    "scratch": {
        "high": "remove scratches, blemishes, and physical damage using advanced inpainting",
        "medium": "repair visible scratches and minor damage",
        "low": "touch up small blemishes and imperfections",
    },
    "fade": {
        "high": "restore vibrant colors and dramatically improve contrast",
        "medium": "enhance color vibrancy and increase contrast",
        "low": "slightly boost colors and improve contrast",
    },
    "colorShift": {
        "high": "correct severe color cast and restore natural white balance",
        "medium": "adjust color balance and improve white balance",
        "low": "fine-tune color balance for natural appearance",
    },
}

BASE_INSTRUCTIONS = {
    "quality": "Maintain the highest possible image quality and preserve important details",
    "naturalness": "Ensure the result looks natural and realistic, avoiding over-processing",
    "preservation": "Preserve the original composition, subject matter, and artistic intent",
}

ISSUE_THRESHOLD = 0.3
MAX_ISSUES = 3
MAX_PROMPT_LEN = 1000



def determine_severity(confidence: float) -> str:
    if confidence >= 0.7:
        return "high"
    if confidence >= 0.5:
        return "medium"
    return "low"


def identify_top_issues(degradation: dict[str, float]) -> list[dict]:
    issues = [
        {"type": t, "confidence": float(c), "severity": determine_severity(float(c))}
        for t, c in degradation.items()
        if float(c) > ISSUE_THRESHOLD
    ]
    issues.sort(key=lambda i: i["confidence"], reverse=True)
    return issues[:MAX_ISSUES]


class PromptEnhancerService:
    def __init__(self, logger=None):
        self.logger = logger or get_logger("prompt-enhancer")
        self._tracer = get_tracer("prompt-enhancer")

    def enhance(
        self,
        degradation: dict[str, float],
        user_prompt: str | None = None,
        options: dict | None = None,
    ) -> str:
        with self._tracer.span(
            "promptEnhancer.enhance",
            {
                "prompt.has_user_input": bool(user_prompt),
                "prompt.user_length": len(user_prompt or ""),
            },
        ) as span:
            issues = identify_top_issues(degradation)
            span.set_attributes(
                {
                    "prompt.issue_count": len(issues),
                    "prompt.top_issues": ",".join(f"{i['type']}:{i['severity']}" for i in issues),
                }
            )
            instructions = self._degradation_instructions(issues)
            prompt = self._build_prompt(user_prompt, instructions, issues)
            span.set_attributes(
                {
                    "prompt.final_length": len(prompt),
                    "prompt.instruction_count": len(instructions),
                }
            )
            return prompt

    def _degradation_instructions(self, issues: list[dict]) -> list[str]:
        out = []
        for issue in issues:
            template = DEGRADATION_TEMPLATES.get(issue["type"])
            if template is None:
                self.logger.warn(f"No template for degradation type: {issue['type']}")
                out.append(f"address {issue['type']} issues")
            else:
                out.append(template.get(issue["severity"], template["medium"]))
        return out

    def _build_prompt(
        self, user_prompt: str | None, instructions: list[str], issues: list[dict]
    ) -> str:
        parts = []
        if user_prompt and user_prompt.strip():
            parts.append(f"User request: {user_prompt.strip()}.")
        if instructions:
            parts.append(f"Technical restoration: {', '.join(instructions)}.")
        quality = ", ".join(
            [
                BASE_INSTRUCTIONS["quality"],
                BASE_INSTRUCTIONS["naturalness"],
                BASE_INSTRUCTIONS["preservation"],
            ]
        )
        parts.append(f"Quality guidelines: {quality}.")
        if any(i["severity"] == "high" for i in issues):
            parts.append(
                "This image requires significant restoration work - apply corrections carefully to avoid artifacts."
            )
        elif not issues:
            parts.append(
                "This image appears to be in good condition - apply subtle enhancements only."
            )
        prompt = " ".join(parts)
        if len(prompt) > MAX_PROMPT_LEN:
            self.logger.warn(
                "Prompt truncated due to length", {"originalLength": len(prompt)}
            )
            prompt = prompt[:950] + "..."
        return prompt
