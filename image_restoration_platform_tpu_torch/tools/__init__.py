"""Operator entry points around the service: the deployment smoke test
(``smoke``), the concurrent HTTP load test (``loadtest``) and the secrets
gate (``validate_secrets``), each as
``python -m image_restoration_platform_tpu_torch.tools.<name>``. The HTTP
clients import aiohttp inside ``main``, so every module imports without it."""
