"""The retrain-and-promote chain of the port: the card work queue that runs
chunked training payloads from a manifest (``chip_queue``, manifests under
``queues/``), the ranker of the chunks' snapshots (``rank_candidates``) and
the promotion gate (``validate_staging``), each as
``python -m image_restoration_platform_tpu_torch.retrain.<name>``."""
