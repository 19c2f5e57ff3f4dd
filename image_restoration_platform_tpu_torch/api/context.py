"""Service composition root: the service graph behind the HTTP routes.

Counterpart of image_restoration_platform_tpu/api/context.py: store -> rate
limiter / idempotency / credits (with the durable user and ledger tier);
moderation; engine -> batcher -> restorator, with the classifier and the
prompt enhancer; job store -> queue (with the refund-on-exhaustion
compensation hook and crash recovery); blobs. ``AppContext`` runs on
``device="cuda"`` unless the caller asks for the CPU, and hands that device
to the engine, the batcher, the restorator and the classifier. This module
imports no aiohttp, so the service graph runs where the HTTP layer cannot.
"""

from __future__ import annotations

import base64

from ..classify import ClassifierService
from ..config import Config, load_config
from ..obs.tracing import get_tracer
from ..prompt import PromptEnhancerService
from ..serve import (
    CreditsService,
    IdempotencyService,
    JobQueue,
    MicroBatcher,
    ModerationService,
    RateLimiter,
    RestorationEngine,
    RestoratorService,
    create_store,
    resolve_device,
)
from ..serve.blobs import create_blob_store
from ..serve.durable import create_durable_tier, create_job_store
from ..serve.jobs import Job
from ..serve.vision import create_vision_client
from ..utils.logging import get_logger


class AppContext:
    def __init__(
        self,
        config: Config | None = None,
        engine: RestorationEngine | None = None,
        use_batcher: bool = True,
        queue_workers: int = 2,
        device: str = "cuda",
    ):
        self.device = resolve_device(device)
        self.config = config or load_config()
        self.logger = get_logger("app")
        self._tracer = get_tracer("app")
        self.store = create_store()
        self.rate_limiter = RateLimiter(self.store, self.config.rate_limit)
        self.idempotency = IdempotencyService(self.store)
        self.user_store, self.ledger = create_durable_tier()
        self.credits = CreditsService(
            store=self.store,
            user_store=self.user_store,
            ledger=self.ledger,
            config=self.config.credits,
        )
        self.moderation = ModerationService(vision_client=create_vision_client())
        self.engine = engine or RestorationEngine(device=self.device, serving_config=self.config.serving)
        self.batcher = (
            MicroBatcher(self.engine, self.config.serving, device=self.device) if use_batcher else None
        )
        self.classifier = ClassifierService(device=self.device)
        self.prompt_enhancer = PromptEnhancerService()
        self.restorator = RestoratorService(
            engine=self.engine,
            classifier=self.classifier,
            prompt_enhancer=self.prompt_enhancer,
            serving_config=self.config.serving,
            batcher=self.batcher,
            device=self.device,
        )
        # durable when DURABLE_DB_PATH is set (same selection rule as the
        # user/ledger tier): job records + results survive restarts
        self.jobs = create_job_store(
            keep_completed=self.config.queue.keep_completed,
            keep_failed=self.config.queue.keep_failed,
        )
        self.queue = JobQueue(
            self.jobs,
            handler=self._process_job,
            config=self.config.queue,
            workers=queue_workers,
            on_exhausted=self._refund_job,
        )
        # crash recovery: re-enqueue the jobs a previous process left queued
        # or mid-attempt, so billed credits keep pointing at live jobs
        recovered = self.jobs.recover_incomplete()
        for job in recovered:
            self.queue.enqueue(job)
        if recovered:
            self.logger.info("Recovered incomplete jobs", {"count": len(recovered)})
        # disk-backed with per-prefix retention when BLOB_STORE_PATH is set,
        # else in memory
        self.blobs = create_blob_store(self.store)

    # ------------------------------------------------------- job execution

    def _process_job(self, job: Job) -> dict:
        """Worker body: decode the payload, run the restore (or fusion)
        pipeline, keep the restored image in the result blob tier; traced
        as ``job.process``, with ``blobs.put_result`` in it."""
        with self._tracer.span("job.process", {"job.id": job.id}):
            payload = job.payload
            images_b64 = payload.get("imagesB64") or [payload["imageB64"]]
            user_context = {"userId": job.user_id, "jobId": job.id}
            options = payload.get("options") or {}
            if len(images_b64) > 1:
                result = self.restorator.restore_fusion(
                    [base64.b64decode(b) for b in images_b64],
                    user_prompt=payload.get("prompt"),
                    user_context=user_context,
                    options=options,
                )
            else:
                result = self.restorator.restore(
                    base64.b64decode(images_b64[0]),
                    user_prompt=payload.get("prompt"),
                    user_context=user_context,
                    options=options,
                )
            if result.get("success") and result.get("restoredImage"):
                # durable result tier (restored/<jobId>): downloadable after
                # the job-record retention window trims the job store
                try:
                    with self._tracer.span("blobs.put_result"):
                        self.blobs.put_result(
                            job.id,
                            base64.b64decode(result["restoredImage"]),
                            user_id=job.user_id,
                        )
                except Exception as error:  # non-fatal: the job result still carries it
                    self.logger.warn("Result blob store failed", {"jobId": job.id, "error": str(error)})
            return result

    def _refund_job(self, job: Job) -> None:
        """Dead-letter compensation: refund the credit charged at submit."""
        try:
            self.credits.refund(job.user_id, job.id, reason="Job failed after retries")
        except Exception as error:  # pragma: no cover
            self.logger.error("Refund hook failed", {"jobId": job.id, "error": str(error)})

    def shutdown(self) -> None:
        self.queue.shutdown()
        if self.batcher is not None:
            self.batcher.shutdown()
