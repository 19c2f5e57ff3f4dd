"""CLI over the secrets gate (reference: scripts/validate-secrets.js).

Port of scripts/validate_secrets.py, over the port's
``config.assert_required_secrets`` / ``list_required_secrets``: exits 1
listing any missing required secrets on stderr unless ALLOW_DEGRADED=1, and
prints one line on stdout otherwise:

    python -m image_restoration_platform_tpu_torch.tools.validate_secrets
"""

from ..config import assert_required_secrets, list_required_secrets


def main() -> None:
    missing = assert_required_secrets(exit_on_missing=True)
    if missing:
        print(f"degraded mode: missing {', '.join(missing)} (ALLOW_DEGRADED=1)")
    else:
        print(f"all required secrets present: {', '.join(list_required_secrets())}")


if __name__ == "__main__":
    main()
