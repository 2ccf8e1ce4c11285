"""The port's fault-tolerance runtime and telemetry on the CPU
(src/repro_torch/runtime, obs/telemetry.py, obs/report.py): the same seed
samples the same FaultPlan, the same mesh and device count replan to the
same mesh, the same loss series raises the same spike alerts and the
same restart policy draws the same delays as in the JAX package; the
heartbeat drill of tests/test_fault_inject.py; the trainer's heartbeats,
resume after a restart (tests/test_trainer_e2e.py), early stop on a loss
spike; the obs report as a planner calibration input; and the training
CLI's checkpoint, supervision, drill, telemetry and export flags.

The trainers run the qwen2.5-14b smoke config (2 layers, d_model 64) on
2 x 16 tokens, LMS off unless said. Comparisons with the JAX package are
exact: both sides are the same stdlib code over the same inputs.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

from tests.test_torch_ref import jax_ref, jax_ref_scope  # noqa: F401 (autouse fixture)

from repro_torch.config.base import (DDLConfig, LMSConfig, MeshSpec, ShapeConfig,
                                     TrainConfig)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as launch
from repro_torch.obs import (SpikeDetector, TelemetryAlert, TelemetryLoop,
                             build_obs_report, export_chrome_trace, load_obs_report,
                             write_obs_report)
from repro_torch.runtime import (FailureDetector, FaultEvent, FaultInjector, FaultPlan,
                                 HeartbeatStore, RestartPolicy, apply_decision, replan_mesh)
from repro_torch.train.trainer import Trainer

ARCH = "qwen2.5-14b"


@pytest.fixture(scope="module")
def ref():
    return jax_ref()


def _events(plan):
    return [(e.site, e.at, e.kind, e.times, e.payload) for e in plan.events]


@pytest.mark.parametrize("seed", [0, 1, 7, 123, 2024])
def test_fault_plan_sample_matches_jax(ref, seed):
    """FaultPlan.sample: every site, and the CLI's two, the same events."""
    from repro.runtime import inject as jinject
    from repro_torch.runtime import inject
    assert inject.SITES == jinject.SITES and inject.SITE_KINDS == jinject.SITE_KINDS
    for kw in ({}, {"sites": ("trainer.step", "ckpt.commit")}, {"n": 5, "horizon": 4}):
        assert _events(FaultPlan.sample(seed, **kw)) == \
            _events(jinject.FaultPlan.sample(seed, **kw))


def test_fault_plan_from_env_matches_jax(ref, monkeypatch):
    from repro.runtime import inject as jinject
    monkeypatch.setenv("REPRO_FAULT_SEED", "31")
    assert _events(FaultPlan.from_env()) == _events(jinject.FaultPlan.from_env())
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultEvent("nowhere", at=0)


def test_replan_mesh_matches_jax_on_a_grid(ref):
    """Meshes of 1-3 axes, data 1-8, pods 1-2, microbatches 1-2, against
    every device count up to the mesh's: the same decision (mesh,
    microbatches, note) and the same config after `apply_decision`; too
    few devices for the model axis raises in both."""
    from repro.config import base as jb
    from repro.runtime import elastic as jel
    model = get_smoke_config(ARCH)
    jmodel = ref.get_smoke_config(ARCH)
    shape = ShapeConfig("t", "train", 16, 8)
    meshes = [((d,), ("data",)) for d in (1, 2, 4)]
    meshes += [((d, m), ("data", "model")) for d in (1, 2, 3, 8) for m in (1, 2)]
    meshes += [((p, d, 1), ("pod", "data", "model")) for p in (1, 2) for d in (1, 2, 4)]
    checked = 0
    for dims, axes in meshes:
        for micro in (1, 2):
            tcfg = TrainConfig(model=model, shape=shape, mesh=MeshSpec(dims, axes),
                               microbatches=micro, checkpoint_dir=None)
            jt = jb.TrainConfig(model=jmodel, shape=jb.ShapeConfig("t", "train", 16, 8),
                                mesh=jb.MeshSpec(dims, axes), microbatches=micro)
            for n in range(1, math.prod(dims) + 1):
                try:
                    want = jel.replan_mesh(jt, n)
                except RuntimeError as e:
                    with pytest.raises(RuntimeError, match=str(e)):
                        replan_mesh(tcfg, n)
                    continue
                got = replan_mesh(tcfg, n)
                assert (got.mesh.shape, got.mesh.axes, got.microbatches, got.note) == \
                    (want.mesh.shape, want.mesh.axes, want.microbatches, want.note)
                new, jnew = apply_decision(tcfg, got), jel.apply_decision(jt, want)
                assert (new.mesh.shape, new.microbatches) == (jnew.mesh.shape,
                                                              jnew.microbatches)
                checked += 1
    assert checked > 100


def _loss_series(seed):
    """A noisy, slowly falling loss curve with two spikes (steps 31 and 56)
    and a plateau."""
    rng = np.random.default_rng(seed)
    x = 3.0 - 0.005 * np.arange(80) + 0.02 * rng.standard_normal(80)
    x[30] += 1.5
    x[55] += 0.4
    x[60:] = x[60]
    return [float(v) for v in x]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spike_detector_matches_jax(ref, seed):
    """The same loss series gives the same alerts (step, value, median,
    threshold) in both packages, at the defaults and at a tight window."""
    from repro.obs import telemetry as jtel
    for kw in ({}, {"window": 8, "factor": 3.0, "min_delta": 0.01, "min_steps": 4}):
        det, jdet = SpikeDetector(**kw), jtel.SpikeDetector(**kw)
        got, want = [], []
        for i, v in enumerate(_loss_series(seed)):
            a, b = det.observe(i + 1, v), jdet.observe(i + 1, v)
            got.append(a.to_dict() if a else None)
            want.append(b.to_dict() if b else None)
        assert got == want
        assert any(g is not None for g in got)


def test_telemetry_loop_actions():
    """record keeps going, stop sets stop_requested, raise raises the
    alert; each counts on the obs registry."""
    from repro_torch.obs import Obs
    series = _loss_series(0)[:40]
    for action in ("record", "stop", "raise"):
        obs = Obs()
        seen = []
        loop = TelemetryLoop(action=action, obs=obs, on_alert=[seen.append])
        try:
            for i, v in enumerate(series):
                loop.observe(i + 1, {"loss": v})
        except TelemetryAlert as e:
            assert action == "raise" and e.step == 31
        assert seen and seen[0].step == 31
        assert loop.stop_requested == (action == "stop")
        assert obs.registry.counter("telemetry.alerts").value >= 1


def test_restart_policy_delays_match_jax(ref):
    from repro.runtime import fault as jfault
    for kw in ({}, {"jitter": False}, {"seed": 5, "max_restarts": 4, "backoff_base": 0.5}):
        pol, jpol = RestartPolicy(**kw), jfault.RestartPolicy(**kw)
        assert [pol.next_delay() for _ in range(12)] == [jpol.next_delay() for _ in range(12)]
    pol = RestartPolicy(max_restarts=2, stable_steps=3)
    pol.next_delay()
    pol.record_success(3)
    assert pol.restarts == 0


def test_failure_detector_dead_and_stragglers(tmp_path):
    hb = HeartbeatStore(str(tmp_path))
    for p, dt in ((0, 1.0), (1, 1.1), (2, 5.0)):
        hb.beat(p, 10, dt)
    beats = hb.read_all()
    dead, slow = FailureDetector(timeout=60.0).check(beats, expected=[0, 1, 2, 3])
    assert dead == [3] and slow == [2]
    dead, _ = FailureDetector(timeout=60.0).check(beats, [0, 1], now=beats[0].t + 61)
    assert dead == [0, 1]


# ---------------------------------------------------------------------------
# the trainer's heartbeats, restart and telemetry
# ---------------------------------------------------------------------------

def test_heartbeat_dead_and_torn_kinds(tmp_path):
    """"dead" drops the beat; "torn" leaves an unparseable file: both look
    like a missing process to read_all and the FailureDetector."""
    from types import SimpleNamespace
    hb = HeartbeatStore(str(tmp_path))
    inj = FaultInjector(FaultPlan([FaultEvent("heartbeat", at=1, kind="dead"),
                                   FaultEvent("heartbeat", at=2, kind="torn")]))
    t = SimpleNamespace(hb=hb, process=0, _inj=inj)
    Trainer._beat(t, 1, 0.1)
    assert hb.read_all()[0].step == 1
    Trainer._beat(t, 2, 0.1)
    assert hb.read_all()[0].step == 1
    Trainer._beat(t, 3, 0.1)
    assert hb.read_all() == {}
    dead, _ = FailureDetector(timeout=60.0).check({}, expected=[0])
    assert dead == [0]


def _tcfg(tmp_path, steps=8, name="ckpt", **kw):
    return TrainConfig(model=get_smoke_config(ARCH), shape=ShapeConfig("t", "train", 16, 2),
                       mesh=MeshSpec((1, 1), ("data", "model")),
                       lms=kw.pop("lms", LMSConfig(enabled=False)), ddl=DDLConfig(mode="none"),
                       learning_rate=5e-3, warmup_steps=2, total_steps=steps,
                       checkpoint_dir=str(tmp_path / name), checkpoint_every=4,
                       async_checkpoint=False, **kw)


def test_restart_resumes(tmp_path):
    """A new Trainer over the same directory resumes from the last
    committed step: its history starts at step 5 (tests/test_trainer_e2e.py)."""
    Trainer(_tcfg(tmp_path, steps=4), device="cpu").train(steps=4)
    tr2 = Trainer(_tcfg(tmp_path, steps=8), device="cpu")
    state, start = tr2.resume_or_init()
    assert start == 4 and int(state.step) == 4
    _, hist2 = tr2.train(steps=8)
    assert hist2[0]["step"] == 5 and hist2[-1]["step"] == 8
    assert tr2.ckpt.all_steps() == [4, 8]


def test_heartbeats_written(tmp_path):
    hb_dir = str(tmp_path / "hb")
    tr = Trainer(_tcfg(tmp_path, steps=2), device="cpu", heartbeat_dir=hb_dir)
    tr.train(steps=2)
    beats = HeartbeatStore(hb_dir).read_all()
    assert 0 in beats and beats[0].step == 2


def test_no_checkpoint_dir_means_no_checkpoints(tmp_path):
    """checkpoint_dir=None (the port's own setting): no Checkpointer, no
    writer wait in the step, and two runs each start from step 0."""
    tcfg = dataclasses.replace(_tcfg(tmp_path, steps=2), checkpoint_dir=None)
    for _ in range(2):
        tr = Trainer(tcfg, device="cpu")
        assert tr.ckpt is None and tr.step_fn.before_update is None
        _, hist = tr.train(steps=2)
        assert [r["step"] for r in hist] == [1, 2]
    assert not (tmp_path / "ckpt").exists()


def test_telemetry_stop_checkpoints_and_ends_early(tmp_path):
    """A loop whose detector fires as soon as it may (its threshold a unit
    below the median) with action "stop" ends the run at that step, the
    third, and checkpoints it, though off the cadence."""
    loop = TelemetryLoop(SpikeDetector(window=4, factor=-1e6, min_delta=-1.0, min_steps=2),
                         action="stop")
    tr = Trainer(_tcfg(tmp_path, steps=8), device="cpu", telemetry=loop)
    _, hist = tr.train(steps=8)
    assert loop.alerts and hist[-1]["step"] == loop.alerts[0].step == 3
    assert tr.ckpt.all_steps() == [3]
    assert tr.obs.registry.counter("telemetry.alerts").value == 1


def test_obs_report_calibrates_the_planner(tmp_path):
    """The report a streamed run writes (`write_obs_report`) passes the
    cost model's schema gate (`load_obs_report`) and `CostModel.from_reports`
    prices from it; the Chrome trace holds the run's step spans and the
    checkpoint's."""
    from repro_torch.core.lms.costmodel import CostModel
    from repro_torch.obs import get_obs
    tr = Trainer(_tcfg(tmp_path, steps=2, lms=LMSConfig(hbm_budget=600_000)),
                 device="cpu", obs=get_obs())
    tr.train(steps=2)
    path = tmp_path / "obs_report.json"
    report = write_obs_report(str(path), obs=get_obs(), meta={"arch": ARCH})
    assert load_obs_report(str(path))["schema"] == report["schema"] == 1
    assert report["compute_spans"] >= 2 and report["meta"] == {"arch": ARCH}
    assert report["registry"]["counters"]["lms.swap_in_bytes.params"] > 0
    model = CostModel.from_reports(report)
    assert model.calibrated and model.mean_step_s > 0
    assert build_obs_report(get_obs())["events"] >= report["events"]
    doc = export_chrome_trace(get_obs().ring.events(), str(tmp_path / "trace.json"))
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"train.step", "ckpt.save", "ckpt.commit"} <= names
    assert json.loads((tmp_path / "trace.json").read_text()) == doc


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

ARGS = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
        "--no-lms"]


def _steps(out):
    return [int(line.split("|")[0].split()[1]) for line in out.splitlines()
            if line.startswith("step ")]


def test_cli_resumes_from_its_checkpoints(capsys, tmp_path):
    """--ckpt-dir run twice: the second run resumes from the first's
    final checkpoint and trains only the steps after it."""
    ckpt = ["--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "2"]
    assert launch.main(ARGS + ckpt + ["--steps", "3"]) == 0
    assert _steps(capsys.readouterr().out) == [1, 2, 3]
    assert launch.main(ARGS + ckpt + ["--steps", "5"]) == 0
    assert _steps(capsys.readouterr().out) == [4, 5]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_00000002", "step_00000003", "step_00000004", "step_00000005"][-3:]


def test_cli_supervised_fault_drill_finishes(capsys, tmp_path):
    """--supervise --fault-step 3 with checkpoints every 2 steps: the run
    dies before step 4, restarts from step 2 (replaying step 3), ends at
    step 5 with the recovery line, and its losses equal an unsupervised
    run's; the heartbeats, trace and obs report are written and the spike
    telemetry records."""
    log = tmp_path / "sup.json"
    extra = ["--heartbeat-dir", str(tmp_path / "hb"), "--trace", str(tmp_path / "t.json"),
             "--obs-report", str(tmp_path / "r.json"), "--spike-action", "record"]
    assert launch.main(ARGS + ["--steps", "5", "--ckpt-dir", str(tmp_path / "a"),
                               "--ckpt-every", "2", "--supervise", "--fault-step", "3",
                               "--log", str(log)] + extra) == 0
    out = capsys.readouterr().out
    assert _steps(out) == [1, 2, 3, 3, 4, 5]
    assert "recovered from 1 failure(s) in 2 attempts" in out
    assert "sup.restarts: 1" in out
    assert launch.main(ARGS + ["--steps", "5", "--ckpt-dir", str(tmp_path / "b"),
                               "--log", str(tmp_path / "plain.json")]) == 0
    sup, plain = (json.loads(p.read_text()) for p in (log, tmp_path / "plain.json"))
    assert [r["loss"] for r in sup] == [r["loss"] for r in plain]
    assert HeartbeatStore(str(tmp_path / "hb")).read_all()[0].step == 5
    assert load_obs_report(str(tmp_path / "r.json"))["compute_spans"] >= 6
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]


def test_cli_fault_seed_and_unsupervised_fault(tmp_path):
    """--fault-seed samples a plan over trainer.step and ckpt.commit;
    under --supervise the run survives it; without --supervise the
    injected fault ends the run."""
    from repro_torch.runtime import InjectedFault
    assert launch.main(ARGS + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a"),
                               "--ckpt-every", "2", "--supervise", "--fault-seed", "3"]) == 0
    with pytest.raises(InjectedFault):
        launch.main(ARGS + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b"),
                            "--fault-step", "1"])
