"""Quality evaluation of the port: the eval tools of scripts/eval_*.py as
``python -m image_restoration_platform_tpu_torch.eval.<name>``, their shared
helpers (``common``), and the quality gates of tests/test_quality*.py as
functions (``gates``) that the CPU tests and chip_smoke.py both run."""
