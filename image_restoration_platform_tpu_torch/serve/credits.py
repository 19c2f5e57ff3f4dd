"""Credits: atomic free-tier + paid-credit accounting with an audit ledger.

Contract from the reference (services/credits.js): a daily free tier
(3/day, UTC midnight reset, key ``free_usage:<uid>:<YYYY-MM-DD>``) consumed
before paid credits (:39-134); free consumption is an atomic
INCR-with-limit (:291-309), paid deduction an atomic check-and-decrement
(:346-366) against a cached balance with write-behind to the durable user
store (:459-469); every movement lands in a ledger (:471-488, non-blocking);
refunds look up the original deduction by jobId and reverse it by type
(:144-218, 490-509).

The durable tier (Firestore in the reference) is the pluggable
``DurableUserStore``/``Ledger`` pair; defaults are in-memory.
"""

from __future__ import annotations

import threading
import time
import uuid
from datetime import datetime, timezone
from typing import Any

from ..config import CreditsConfig
from ..obs.tracing import get_tracer
from ..utils.logging import get_logger
from .store import MemoryStore


class DurableUserStore:
    """users/<uid>.credits durable tier (Firestore equivalent, in-memory)."""

    def __init__(self):
        self._users: dict[str, dict] = {}
        self._lock = threading.Lock()

    def get_credits(self, user_id: str) -> int:
        with self._lock:
            return int(self._users.get(user_id, {}).get("credits", 0))

    def set_credits(self, user_id: str, balance: int) -> None:
        with self._lock:
            user = self._users.setdefault(user_id, {})
            user["credits"] = int(balance)
            user["lastUpdated"] = time.time()

    def grant(self, user_id: str, amount: int) -> int:
        with self._lock:
            user = self._users.setdefault(user_id, {"credits": 0})
            user["credits"] = int(user.get("credits", 0)) + amount
            return user["credits"]


class Ledger:
    """credit_ledger audit trail with jobId queries (credits.js:471-509)."""

    def __init__(self):
        self._entries: list[dict] = []
        self._lock = threading.Lock()

    def add(self, entry: dict) -> str:
        with self._lock:
            entry = dict(entry)
            entry["id"] = uuid.uuid4().hex
            entry["timestamp"] = time.time()
            self._entries.append(entry)
            return entry["id"]

    def find_deduction_by_job(self, job_id: str) -> dict | None:
        with self._lock:
            for entry in self._entries:
                if entry.get("jobId") == job_id and entry.get("amount", 0) < 0:
                    return dict(entry)
        return None

    def entries(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._entries]


class CreditsService:
    def __init__(
        self,
        store: MemoryStore | None = None,
        user_store: DurableUserStore | None = None,
        ledger: Ledger | None = None,
        config: CreditsConfig | None = None,
        logger=None,
    ):
        self.store = store or MemoryStore()
        self.users = user_store or DurableUserStore()
        self.ledger = ledger or Ledger()
        self.config = config or CreditsConfig()
        self.logger = logger or get_logger("credits")
        self._tracer = get_tracer("credits")

    # ------------------------------------------------------------ public

    def check_and_deduct(self, user_id: str, amount: int = 1, job_id: str | None = None) -> dict:
        with self._tracer.span(
            "credits.checkAndDeduct",
            {"credits.user_id": user_id, "credits.amount": amount, "credits.job_id": job_id or "unknown"},
        ) as span:
            free_used = self._daily_free_usage(user_id)
            daily_limit = self._daily_free_limit(user_id)

            # free tier is consumed before paid regardless of amount
            # (credits.js:60-86 takes the free path whenever under the limit)
            if free_used < daily_limit:
                if self._consume_free_credit(user_id, job_id):
                    span.set_attributes({"credits.type": "free", "credits.daily_used": free_used + 1})
                    return {
                        "allowed": True,
                        "type": "free",
                        "remainingCredits": daily_limit - free_used - 1,
                        "dailyFreeUsed": free_used + 1,
                        "dailyFreeLimit": daily_limit,
                    }

            paid = self._check_and_deduct_paid(user_id, amount, job_id)
            span.set_attributes({"credits.type": "paid", "credits.allowed": paid["allowed"]})
            return {
                **paid,
                "type": "paid",
                "dailyFreeUsed": free_used,
                "dailyFreeLimit": daily_limit,
            }

    def refund(self, user_id: str, job_id: str, amount: int = 1, reason: str = "Job failed") -> dict:
        with self._tracer.span(
            "credits.refund",
            {"credits.user_id": user_id, "credits.job_id": job_id, "credits.amount": amount},
        ):
            original = self.ledger.find_deduction_by_job(job_id)
            if original is None:
                self.logger.warn("No original transaction found for refund", {"userId": user_id, "jobId": job_id})
                return {"success": False, "reason": "Original transaction not found"}

            if original["type"] == "free":
                result = self._refund_free(user_id)
            else:
                result = self._refund_paid(user_id, amount)

            self.ledger.add(
                {
                    "userId": user_id,
                    "jobId": job_id,
                    "amount": amount,
                    "type": "refund",
                    "reason": reason,
                    "originalTransactionId": original["id"],
                }
            )
            self.logger.info(
                "Refund completed",
                {"userId": user_id, "jobId": job_id, "success": result["success"], "type": original["type"]},
            )
            return result

    def get_balance(self, user_id: str) -> dict:
        paid = self._load_balance_into_cache(user_id)
        free_used = self._daily_free_usage(user_id)
        daily_limit = self._daily_free_limit(user_id)
        free_remaining = max(0, daily_limit - free_used)
        return {
            "paidCredits": paid,
            "freeCredits": free_remaining,
            "dailyFreeUsed": free_used,
            "dailyFreeLimit": daily_limit,
            "totalAvailable": paid + free_remaining,
        }

    # ----------------------------------------------------------- private

    def _today_key(self) -> str:
        return datetime.now(timezone.utc).strftime("%Y-%m-%d")

    def _daily_free_limit(self, user_id: str) -> int:
        return self.config.daily_free_limit

    def _daily_free_usage(self, user_id: str) -> int:
        value = self.store.get(f"free_usage:{user_id}:{self._today_key()}")
        return int(value or 0)

    def _consume_free_credit(self, user_id: str, job_id: str | None) -> bool:
        key = f"free_usage:{user_id}:{self._today_key()}"
        new = self.store.incr_with_limit(key, self._daily_free_limit(user_id), 86400)
        if new > 0:
            self._record(user_id, job_id, -1, "free", "Daily free credit consumed")
            return True
        return False

    def _cache_key(self, user_id: str) -> str:
        return f"credits:{user_id}"

    def _load_balance_into_cache(self, user_id: str) -> int:
        key = self._cache_key(user_id)
        balance = self.store.get(key)
        if balance is None:
            balance = self.users.get_credits(user_id)
            self.store.set(key, balance, self.config.cache_ttl_seconds)
        return int(balance)

    def _check_and_deduct_paid(self, user_id: str, amount: int, job_id: str | None) -> dict:
        self._load_balance_into_cache(user_id)
        ok, balance = self.store.check_and_decrement(
            self._cache_key(user_id), amount, self.config.cache_ttl_seconds
        )
        if ok:
            # write-behind to the durable tier (credits.js:369-372)
            try:
                self.users.set_credits(user_id, balance)
            except Exception as error:  # pragma: no cover
                self.logger.error("Durable sync failed", {"userId": user_id, "error": str(error)})
            self._record(user_id, job_id, -amount, "paid", "Credit consumed for job")
            return {"allowed": True, "remainingCredits": balance}
        return {"allowed": False, "remainingCredits": balance}

    def _refund_free(self, user_id: str) -> dict:
        key = f"free_usage:{user_id}:{self._today_key()}"
        current = int(self.store.get(key) or 0)
        if current > 0:
            self.store.decr(key)
            return {"success": True, "type": "free"}
        return {"success": False, "reason": "No free credits to refund"}

    def _refund_paid(self, user_id: str, amount: int) -> dict:
        # seed the cache from the durable tier first: a cold cache (fresh
        # process) would otherwise refund against an implicit 0 balance and
        # clobber the durable value on write-behind
        self._load_balance_into_cache(user_id)
        new_balance = self.store.incr_by(self._cache_key(user_id), amount)
        self.store.expire(self._cache_key(user_id), self.config.cache_ttl_seconds)
        try:
            self.users.set_credits(user_id, new_balance)
        except Exception as error:  # pragma: no cover
            self.logger.error("Durable refund sync failed", {"userId": user_id, "error": str(error)})
        return {"success": True, "newBalance": new_balance, "type": "paid"}

    def _record(self, user_id: str, job_id: str | None, amount: int, type_: str, reason: str) -> None:
        try:
            self.ledger.add(
                {"userId": user_id, "jobId": job_id, "amount": amount, "type": type_, "reason": reason}
            )
        except Exception as error:  # ledger failure must not block credit ops
            self.logger.error("Failed to record transaction", {"userId": user_id, "error": str(error)})


def create_credits_service(**kwargs: Any) -> CreditsService:
    return CreditsService(**kwargs)
