"""PyTorch port: the retrain-and-promote chain (retrain/chip_queue.py,
rank_candidates.py, validate_staging.py and the manifests of
retrain/queues/) against the reference scripts of scripts/, loaded through
importlib as tests/test_promotion.py loads them (none imports JAX at the
top).

The reference's own cases of tests/test_promotion.py run as cases of the
port's functions beside the reference's; ``compare_metrics`` and ``_score``
equal the reference's exactly on hypothesis-drawn dicts; the gate -> family
map agrees with ``attribute_gate_failures`` on every gate node id that
pytest collects from tests/test_quality*.py; both ``Runner``s walk one
manifest of shell payloads to the same SUMMARY.json in the same order; the
port's manifests are the reference's apart from the listed ``cmd``
translations. Last, the chain end to end on the CPU at a small size:
restore-unet-small trained 2 steps at 64 b2 through the queue, ranked at
n = 2, gated, and a byte copy of the shipped weights PROMOTEd."""

import ast
import functools
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from image_restoration_platform_tpu_torch.eval import gates as G
from image_restoration_platform_tpu_torch.eval import quality
from image_restoration_platform_tpu_torch.retrain import chip_queue, rank_candidates, validate_staging
from image_restoration_platform_tpu_torch.train.realphoto import available_sources

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("restore-unet", "restore-unet-small", "sr-x2", "sr-x4", "diffusion-restore")


def _load(script_name):
    path = os.path.join(REPO, "scripts", script_name)
    spec = importlib.util.spec_from_file_location("reference_" + script_name.replace(".py", ""), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_vs():
    return _load("validate_staging.py")


@pytest.fixture(scope="module")
def ref_rank():
    return _load("rank_candidates.py")


@pytest.fixture(scope="module")
def ref_queue():
    return _load("chip_queue.py")


# ------------------------------------------------------------ compare_metrics

# tests/test_promotion.py::TestCompareMetrics, case by case:
# (shipped, staged, regressed axes, improved axes or None where unchecked)
COMPARE_CASES = {
    "mean_axes_strict_tolerance": ({"photo": 5.0, "rich": 7.0}, {"photo": 4.4, "rich": 7.6}, ["photo"], ["rich"]),
    **{f"worst_mad_axes_forensics_only[{s}]": ({"ood/clean_worst_mad": -9.64}, {"ood/clean_worst_mad": s}, [], [])
       for s in (-10.26, -10.9, -30.0)},
    "p95_mad_axis_strict_tolerance": ({"ood/clean_p95_mad": -9.64}, {"ood/clean_p95_mad": -10.9},
                                      ["ood/clean_p95_mad"], None),
    "mean_harm_axis_still_strict": ({"real/clean_mad": -4.6}, {"real/clean_mad": -5.3}, ["real/clean_mad"], None),
    "missing_axes_ignored": ({"a": 1.0}, {}, [], []),
}


@pytest.mark.parametrize("case", sorted(COMPARE_CASES))
def test_compare_metrics_reference_cases(case, ref_vs):
    shipped, staged, regressed, improved = COMPARE_CASES[case]
    for impl in (validate_staging, ref_vs):
        regs, imps = impl.compare_metrics(shipped, staged, 0.5)
        assert list(regs) == regressed, impl
        if improved is not None:
            assert list(imps) == improved, impl


_AXES = ("photo", "rich", "smooth/clean", "ood/defocus", "ood/clean_mad", "ood/clean_p95_mad",
         "ood/clean_worst_mad", "real/clean_mad", "real/clean_p95_mad", "real/clean_worst_mad", "real/motion")
_VALUES = st.floats(min_value=-40.0, max_value=40.0, allow_nan=False)


@settings(max_examples=200, deadline=None)
@given(shipped=st.dictionaries(st.sampled_from(_AXES), _VALUES),
       staged=st.dictionaries(st.sampled_from(_AXES), _VALUES),
       tolerance=st.sampled_from((0.0, 0.25, 0.5, 1.0)))
def test_compare_metrics_equals_the_reference(ref_vs, shipped, staged, tolerance):
    """Missing, worst-mad, p95 and mean axes drawn at random: the port's
    verdict dicts are the reference's, key order included."""
    port = validate_staging.compare_metrics(shipped, staged, tolerance)
    ref = ref_vs.compare_metrics(shipped, staged, tolerance)
    assert [list(d.items()) for d in port] == [list(d.items()) for d in ref]


_CLASSES = ("poisson_gaussian", "defocus", "motion", "jpeg_q10_60", "vignette_low_light", "chained")
_GAIN_ROW = st.fixed_dictionaries({"gain_db": _VALUES})
_HARM_ROW = st.fixed_dictionaries({"mad_255": st.floats(0, 40), "worst_mad_255": st.floats(0, 80)})


def _corpus():
    return st.builds(lambda gains, harm: {**gains, **({"clean_no_harm": harm} if harm else {})},
                     st.dictionaries(st.sampled_from(_CLASSES), _GAIN_ROW), st.one_of(st.none(), _HARM_ROW))


@settings(max_examples=200, deadline=None)
@given(ood=_corpus(), real=_corpus(),
       indist=st.one_of(st.none(), st.fixed_dictionaries({"rich": _VALUES, "photo": _VALUES})))
def test_score_equals_the_reference(ref_rank, ood, real, indist):
    assert rank_candidates._score(ood, real, indist) == ref_rank._score(ood, real, indist)


# ------------------------------------------------------------ gate attribution


def _collected_gate_nodes() -> list:
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "tests/test_quality.py", "tests/test_quality_ood.py", "tests/test_quality_real.py"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return [line.strip() for line in out.stdout.splitlines() if "::" in line]


def test_gate_map_agrees_with_the_reference_on_every_collected_gate(ref_vs):
    nodes = _collected_gate_nodes()
    assert len(nodes) == 26 and set(nodes) == set(validate_staging.GATE_FAMILY)
    for node in nodes:
        for fam in FAMILIES:
            want = ref_vs.attribute_gate_failures([node], fam)
            assert validate_staging.attribute_gate_failures([node], fam) == want, (node, fam)
        assert ref_vs.attribute_gate_failures([node], validate_staging.GATE_FAMILY[node]) == [node]


Q, OOD, REAL = G.QUALITY_TESTS, G.OOD_TESTS, G.REAL_TESTS
# tests/test_promotion.py::TestGateAttribution, each rule on the real gates:
# (failed node ids, {family: the failures it owns}; every other family owns none)
ATTRIBUTION_CASES = {
    "parametrized_id_routes_to_named_family": (
        [f"{Q}test_sr_photo_distribution_gain[sr-x2]"], {"sr-x2": [0]}),
    "underscored_test_name_routes_to_named_family": (
        [f"{Q}test_sr_x2_beats_nearest_baseline"], {"sr-x2": [0]}),
    "small_beats_prefix_of_flagship_name": (  # no gate reads restore-unet-small; the flagship's stay its own
        [f"{Q}test_flagship_restoration_gain", f"{Q}test_flagship_bounded_harm_on_near_clean[555]"],
        {"restore-unet": [0, 1]}),
    "unnamed_gates_default_to_flagship": (
        [f"{OOD}test_flagship_ood_gain[defocus]", f"{REAL}test_real_photo_clean_harm_bounded"],
        {"restore-unet": [0, 1]}),
    "diffusion_shorthand": (
        [f"{Q}test_diffusion_restoration_gain[heldout-5.0]", f"{Q}test_flagship_restoration_gain"],
        {"diffusion-restore": [0], "restore-unet": [1]}),
    "one_red_family_does_not_hold_the_others": (
        [f"{Q}test_sr_photo_distribution_gain[sr-x4]", f"{Q}test_sr_x4_beats_nearest_baseline"],
        {"sr-x4": [0, 1]}),
}


@pytest.mark.parametrize("case", sorted(ATTRIBUTION_CASES))
def test_gate_attribution_reference_cases(case, ref_vs):
    nodes, owned = ATTRIBUTION_CASES[case]
    for fam in FAMILIES:
        want = [nodes[i] for i in owned.get(fam, [])]
        assert validate_staging.attribute_gate_failures(nodes, fam) == want, fam
        assert ref_vs.attribute_gate_failures(nodes, fam) == want, fam


def _fake_reports(monkeypatch, **values):
    """Every gate report of eval/gates.py replaced by fixed values (a gate
    passes unless ``values`` says otherwise), so ``family_gates`` is
    checked for its routing without a model."""
    monkeypatch.setattr(G, "heldout", lambda *a: None)
    monkeypatch.setattr(G, "flagship_report", lambda *a: {
        "flagship_gain": values.get("flagship_gain", 9.0),
        **{f"near_clean_{s}_{k}": v for s in G.NEAR_CLEAN_SEEDS for k, v in (("psnr", 45.0), ("mad", 0.5))}})
    smooth = {"sr_psnr": 40.0, "nearest_psnr": 39.0, "hf_pred": 1.0, "hf_true": 1.0}
    monkeypatch.setattr(G, "sr_report", lambda name, *a: {
        f"{name}_rich_gain": values.get(f"{name}_rich_gain", 6.0), f"{name}_photo_gain": 2.0, f"{name}_smooth": smooth})
    monkeypatch.setattr(G, "diffusion_report", lambda *a: {"diffusion_rich_gain": 7.0, "diffusion_photo_gain": 5.0})
    monkeypatch.setattr(G, "ood_report", lambda *a: {**{k: v + 1.0 for k, v in G.OOD_GATES.items()},
                                                      "motion_per_image": 2.0, "clean_mean_mad": 1.0,
                                                      "clean_worst_mad": values.get("ood_worst", 2.0)})
    monkeypatch.setattr(G, "real_report", lambda *a: {**{k: v + 1.0 for k, v in G.REAL_GATES.items()},
                                                       "clean_mean_mad": 1.0, "clean_worst_mad": 2.0})


def test_family_gates_run_each_family_s_gates_and_no_other(monkeypatch):
    if not available_sources():
        pytest.skip("no real-photo sources on this machine")
    _fake_reports(monkeypatch)
    seen = {}
    for fam in FAMILIES:
        checks = G.family_gates(fam, None, None, "cpu")
        assert all(message is None for message in checks.values()), checks
        assert {validate_staging.GATE_FAMILY[node] for node in checks} <= {fam}
        seen.update(checks)
    assert set(seen) == set(validate_staging.GATE_FAMILY)
    assert G.family_gates("restore-unet-small", None, None, "cpu") == {}


def test_family_gates_name_the_failed_gate(monkeypatch):
    _fake_reports(monkeypatch, flagship_gain=4.0, ood_worst=20.0, **{"sr-x4_rich_gain": 3.0})
    failed = {fam: [n for n, m in G.family_gates(fam, None, None, "cpu").items() if m] for fam in FAMILIES}
    assert failed == {"restore-unet": [f"{Q}test_flagship_restoration_gain", f"{OOD}test_flagship_ood_clean_no_harm"],
                      "restore-unet-small": [], "sr-x2": [], "sr-x4": [f"{Q}test_sr_x4_beats_nearest_baseline"],
                      "diffusion-restore": []}


def test_gate_failures_keep_in_distribution_messages():
    """``in_distribution_failures`` / ``ood_failures`` (chip_smoke.py's
    phase 8 reads them) are the messages of the failed checks."""
    report = {"flagship_gain": 4.0, **{f"near_clean_{s}_{k}": v for s in G.NEAR_CLEAN_SEEDS
                                       for k, v in (("psnr", 45.0), ("mad", 0.5))}}
    assert G.in_distribution_failures(report) == ["flagship gain 4.000 <= 5.0"]
    ood = {**{k: v + 1.0 for k, v in G.OOD_GATES.items()}, "motion_per_image": 0.5, "clean_mean_mad": 1.0,
           "clean_worst_mad": 2.0}
    assert G.ood_failures(ood) == ["motion per image 0.500 < 1.0"]


# ---------------------------------------------------------------- the Runner


class FakeClock:
    """``time`` for a Runner: ``time()`` holds still while payloads run and
    ``sleep`` moves it on, so the 90 s waits of a blocked queue cost nothing."""

    def __init__(self):
        self.now, self.sleeps = 1_000_000.0, []

    def time(self):
        return self.now

    def sleep(self, seconds):
        self.sleeps.append(seconds)
        self.now += seconds

    def __getattr__(self, name):
        return getattr(time, name)


def _shell_manifest(tmp):
    return [
        {"name": "ok", "cmd": "true", "probe": "none"},
        {"name": "bad", "cmd": "false", "probe": "none"},
        {"name": "grep_miss", "cmd": "echo hello", "probe": "none", "success_grep": "training done",
         "max_attempts": 1},
        {"name": "grep_hit", "cmd": "echo training done", "probe": "none", "success_grep": "training done"},
        {"name": "skipped", "cmd": f"echo ran >> {tmp}/skipped_ran", "probe": "none", "skip_if": f"{tmp}/marker"},
        {"name": "with_post", "cmd": "true", "probe": "none", "post": f"echo post >> {tmp}/post_ran"},
        {"name": "three_tries", "cmd": "false", "probe": "none", "max_attempts": 3},
        {"name": "needs_card", "cmd": "true", "probe": "alive"},
        {"name": "deferred", "cmd": "true", "probe": "none", "min_remaining": 100_000},
    ]


def _walk(module, tmp, monkeypatch):
    os.makedirs(tmp)
    open(os.path.join(tmp, "marker"), "w").close()
    clock = FakeClock()
    monkeypatch.setattr(module, "time", clock)
    monkeypatch.setattr(module, "probe", lambda tier: tier == "none")  # no card answers
    logdir = os.path.join(tmp, "logs")
    module.Runner(_shell_manifest(tmp), clock.now + 1000, logdir).run()
    lines = open(os.path.join(logdir, "runner.log")).read().splitlines()
    starts = [line.split(" ", 1)[1].split(" (budget")[0] for line in lines if ": start attempt " in line]
    summary = json.load(open(os.path.join(logdir, "SUMMARY.json")))
    files = {f: open(os.path.join(tmp, f)).read() for f in ("post_ran",) if os.path.exists(os.path.join(tmp, f))}
    states = sorted(f for f in os.listdir(logdir) if f.endswith((".done", ".failed", ".attempts")))
    return summary, starts, clock.sleeps, files, states


def test_runner_walks_a_manifest_as_the_reference_does(tmp_path, monkeypatch, ref_queue):
    port = _walk(chip_queue, str(tmp_path / "port"), monkeypatch)
    ref = _walk(ref_queue, str(tmp_path / "ref"), monkeypatch)
    assert port == ref
    summary, starts, sleeps, files, _states = port
    assert summary == {"ok": "done", "bad": "failed", "grep_miss": "failed", "grep_hit": "done", "skipped": "done",
                       "with_post": "done", "three_tries": "failed", "needs_card": "pending", "deferred": "pending"}
    assert starts[:6] == ["ok: start attempt 1", "bad: start attempt 1", "grep_miss: start attempt 1",
                          "grep_hit: start attempt 1", "with_post: start attempt 1", "three_tries: start attempt 1"]
    assert starts[6:] == ["bad: start attempt 2", "three_tries: start attempt 2", "three_tries: start attempt 3"]
    assert files == {"post_ran": "post\n"} and sleeps and set(sleeps) == {90}


def test_runner_restarts_from_its_state_files(tmp_path, monkeypatch):
    tmp = str(tmp_path / "q")
    first = _walk(chip_queue, tmp, monkeypatch)
    clock = FakeClock()
    monkeypatch.setattr(chip_queue, "time", clock)
    chip_queue.Runner(_shell_manifest(tmp), clock.now + 1000, os.path.join(tmp, "logs")).run()
    lines = open(os.path.join(tmp, "logs", "runner.log")).read().splitlines()
    assert sum(": start attempt " in line for line in lines) == len(first[1])  # nothing ran again
    assert json.load(open(os.path.join(tmp, "logs", "SUMMARY.json"))) == first[0]


def test_probe_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert chip_queue.probe("none") is True
    assert chip_queue.probe("alive") is False


# ---------------------------------------------------------------- manifests

# the only fields that differ: a cmd that runs the reference package or a
# TPU measurement script
CMD_TRANSLATIONS = {
    "python -m image_restoration_platform_tpu.train": "python -m image_restoration_platform_tpu_torch.train",
    "timeout 2400 python scripts/measure_attention.py": "timeout 2400 python chip_smoke.py --plan-sweep",
    "timeout 2400 python scripts/measure_step_profiled.py": "timeout 2400 python chip_smoke.py --graphs-only",
    "python bench.py > /tmp/chipq/bench_out.json 2> /tmp/chipq/bench_err.log; rc=$?; cat /tmp/chipq/bench_out.json; "
    "exit $rc": "python -m image_restoration_platform_tpu_torch.bench > /tmp/chipq/bench_out.json "
                "2> /tmp/chipq/bench_err.log; rc=$?; cat /tmp/chipq/bench_out.json; exit $rc",
}


@pytest.mark.parametrize("name", ["r5_anchor", "r5_main"])
def test_manifests_are_the_reference_s_apart_from_the_cmds(name):
    ref = json.load(open(os.path.join(REPO, "scripts", "queues", f"{name}.json")))
    text = open(os.path.join(chip_queue.QUEUES, f"{name}.json")).read()
    port = json.loads(text)
    assert [p.keys() for p in port] == [p.keys() for p in ref]
    for p, r in zip(port, ref):
        assert {k: v for k, v in p.items() if k != "cmd"} == {k: v for k, v in r.items() if k != "cmd"}
        assert p["cmd"] == CMD_TRANSLATIONS[r["cmd"]], r["name"]
    assert "image_restoration_platform_tpu." not in text and "scripts/" not in text
    for translated in CMD_TRANSLATIONS.values():  # every translation is listed in the module docstring
        tool = "python " + translated.split("python ")[1].split(" >")[0]
        assert tool in chip_queue.__doc__, tool


# ----------------------------------------------------------- the chain, on the CPU


def _row_keys(script_source: str) -> set:
    """The keys of the verdict row the reference's main() prints."""
    for node in ast.walk(ast.parse(script_source)):
        if isinstance(node, ast.Dict) and any(getattr(k, "value", None) == "verdict" for k in node.keys):
            return {k.value for k in node.keys}
    raise AssertionError("no verdict row in the reference")


def test_chain_on_the_cpu(tmp_path, capsys, monkeypatch):
    """train (the queue, one chunk) -> rank (n = 2) -> gate, at a small size:
    the gate's held-out table at 2 images and 1 batch an axis (its default
    8 x 4 triples the test's time on the CPU)."""
    monkeypatch.setattr(validate_staging, "quality", SimpleNamespace(evaluate=functools.partial(quality.evaluate, 2, 1)))
    family = "restore-unet-small"
    stage, cands = tmp_path / "stage", tmp_path / "cands"
    stage.mkdir()
    cands.mkdir()
    shipped = os.path.join(REPO, "weights", f"{family}.npz")
    subprocess.run(["cp", shipped, str(stage)], check=True)
    manifest = [{
        "name": "small_chunk1",
        "cmd": f"{sys.executable} -c \"from image_restoration_platform_tpu_torch.train.__main__ import main; "
               "main(device='cpu')\"",
        "env": {"IRP_WEIGHTS_DIR": str(stage), "TRAIN_FAMILY": family, "TRAIN_RESUME": "1", "TRAIN_STEPS": "2",
                "TRAIN_BATCH": "2", "TRAIN_SIZE": "64", "TRAIN_SEED": "601", "OMP_NUM_THREADS": "4"},
        "probe": "none", "min_remaining": 300, "skip_if": f"{cands}/{family}.chunk1.npz",
        "success_grep": "training done", "post": f"cp {stage}/{family}.npz {cands}/{family}.chunk1.npz",
        "max_attempts": 1,
    }]
    logdir = tmp_path / "logs"
    chip_queue.Runner(manifest, time.time() + 900, str(logdir)).run()
    assert json.load(open(logdir / "SUMMARY.json")) == {"small_chunk1": "done"}, open(logdir / "small_chunk1.log").read()
    said = [line for line in open(logdir / "small_chunk1.log") if "training done" in line]
    assert said and '"attentionLaunches": 0' in said[0]  # the plain attention on the CPU
    capsys.readouterr()

    results = rank_candidates.main(["--dir", str(cands), "--family", family, "--n", "2", "--include-shipped",
                                    "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == results
    assert sorted(r["candidate"] for r in results) == ["__shipped__", f"{family}.chunk1.npz"]
    assert [r["score"] for r in results] == sorted((r["score"] for r in results), reverse=True)
    classes = (*G.OOD_GATES, "clean_mad", "clean_worst")
    corpora = ("ood", "real") if available_sources() else ("ood",)
    for r in results:
        assert set(r) == {"candidate", "score", "detail"}
        assert set(r["detail"]) == {f"{c}/{k}" for c in corpora for k in classes}

    want = _row_keys(open(os.path.join(REPO, "scripts", "validate_staging.py")).read())
    winner = tmp_path / "winner"
    winner.mkdir()
    src = shipped if results[0]["candidate"] == "__shipped__" else str(cands / results[0]["candidate"])
    subprocess.run(["cp", src, str(winner / f"{family}.npz")], check=True)
    rows = validate_staging.main(["--stage", str(winner), "--family", family, "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert printed == rows and len(rows) == 1
    assert set(rows[0]) == want and rows[0]["family"] == family and rows[0]["verdict"] in ("PROMOTE", "HOLD")

    copy = tmp_path / "copy"
    copy.mkdir()
    subprocess.run(["cp", shipped, str(copy)], check=True)
    axes = {}
    rows = validate_staging.validate(str(copy), device="cpu", axes=axes)  # the families found in the stage
    assert rows == [{"family": family, "verdict": "PROMOTE", "gates_green": True, "gate_failures": [],
                     "regressions": {}, "improvements": {}}]
    assert axes[family]["shipped"] == axes[family]["staged"] and set(axes[family]["shipped"]) == {"rich", "photo"}


def test_chain_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rank_candidates.main(["--dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        validate_staging.main(["--stage", str(tmp_path), "--family", "restore-unet-small"])
