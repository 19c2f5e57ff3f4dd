"""PyTorch port: the measurement-validity guard (utils/measure_guard.py).

Counterparts of the 7 tests of tests/test_measure_guard.py: the stamping
logic with synthetic probe records (the INVALID path pinned by tests), the
probe and ``guarded`` on the CPU (mode cpu, stamped CPU) and with the
device clock (probes skipped, DEVICE_CLOCK). The port's probe names its mode
"cuda" where the reference's says "tpu"; the probe and ``guarded`` take the
device, "cuda" by default (raising without a card). On a card the probe
times a real copy with CUDA events, and ``guarded(clock="device")`` reads
CUDA events around its section (marked ``cuda``)."""

import pytest
import torch

from image_restoration_platform_tpu_torch.utils import measure_guard as mg


class TestStamp:
    def test_host_valid_requires_both_probes(self):
        ok = {"mode": "cuda", "ok": True}
        bad = {"mode": "cuda", "ok": False}
        assert mg.stamp({}, ok, ok)["validity"]["status"] == mg.VALID
        assert mg.stamp({}, ok, bad)["validity"]["status"] == mg.INVALID
        assert mg.stamp({}, bad, ok)["validity"]["status"] == mg.INVALID
        assert mg.stamp({}, bad, bad)["validity"]["status"] == mg.INVALID

    def test_device_clock_exempt(self):
        bad = {"mode": "cuda", "ok": False}
        rec = mg.stamp({}, bad, bad, clock="device")
        assert rec["validity"]["status"] == mg.DEVICE_CLOCK

    def test_cpu_mode(self):
        cpu = {"mode": "cpu", "ok": True}
        assert mg.stamp({}, cpu, cpu)["validity"]["status"] == mg.CPU

    def test_stamp_preserves_record_fields(self):
        ok = {"mode": "cuda", "ok": True}
        rec = mg.stamp({"step_ms": 1.5}, ok, ok)
        assert rec["step_ms"] == 1.5
        assert rec["validity"]["pre"] is ok and rec["validity"]["post"] is ok


class TestProbe:
    def test_cpu_probe_is_noop(self):
        rec = mg.d2h_probe(device="cpu")
        assert rec == {"mode": "cpu", "ok": True}

    def test_guarded_context_cpu(self):
        with mg.guarded(device="cpu") as g:
            pass
        rec = g.stamp({"x": 1})
        assert rec["validity"]["status"] == mg.CPU and rec["x"] == 1

    def test_guarded_device_clock_skips_probes(self):
        with mg.guarded(clock="device", device="cpu") as g:
            pass
        rec = g.stamp({})
        assert rec["validity"]["status"] == mg.DEVICE_CLOCK
        assert g.device_ms is None and "device_ms" not in rec  # the CPU has no device clock


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mg.d2h_probe()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mg.guarded()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the probe times a copy from the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_probe_and_device_clock_on_the_card(cuda_device):
    rec = mg.d2h_probe(device=cuda_device)
    assert rec["mode"] == "cuda" and rec["ok"] and rec["mb_per_s"] > 0
    with mg.guarded(device=cuda_device) as g:
        pass
    assert g.stamp({})["validity"]["status"] == mg.VALID
    with mg.guarded(clock="device", device=cuda_device) as g:
        torch.cuda._sleep(1_000_000)
    rec = g.stamp({})
    assert rec["validity"]["status"] == mg.DEVICE_CLOCK and rec["device_ms"] > 0
