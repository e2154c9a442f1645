"""`python -m mico_tpu_torch.run --device cpu` at 2 processes over gloo on
the CPU, on the tiny corpus of `tests/test_torch_run.py`, joined by JAX's
keys (`run_cfg.multihost`, `coordinator_address` as a `file://`
rendezvous under the test's temporary directory, `num_processes`,
`process_id`) with ZeRO-1 on:

  - two training steps, with an evaluation and a save after each: rank 0
    writes `hps.json`, the log, the checkpoints and `log/record.json`;
  - the step-2 evaluation, gathered from both ranks' shards of each val
    set, equals a one-process evaluation (`run_cfg.mode=testing`) of the
    weights it saved: the gathered items go back in the set's order, so
    also the metrics that break ties by position (the ITM re-rank's floor
    scores; the corrupt clip's resample duplicates another clip) agree;
  - a resume at one process continues the step numbers and the
    optimizer's update count from the file the two ranks wrote (ZeRO-1's
    moments gathered whole).
The two processes run once, from a module fixture.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mico_tpu_torch.run as trun

from test_torch_run import ROOT, ckpt_files, corpus, spy_train  # noqa: F401

WORLD = 2
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def two_ranks(corpus, tmp_path_factory):  # noqa: F811
    _, cfg_path = corpus
    out = str(tmp_path_factory.mktemp("mp_out"))
    store = tmp_path_factory.mktemp("mp_store") / "rendezvous"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mico_tpu_torch.run", "--config",
         str(cfg_path), "--output_dir", out, "--device", "cpu",
         "run_cfg.multihost=true",
         f"run_cfg.coordinator_address=file://{store}",
         f"run_cfg.num_processes={WORLD}", f"run_cfg.process_id={r}",
         "run_cfg.zero1=true"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    with open(os.path.join(out, "log", "record.json")) as f:
        record = json.load(f)
    return out, record, ckpt_files(out), logs


def test_two_ranks_train_and_save_on_rank_0(two_ranks):
    out, rec, files, logs = two_ranks
    assert rec["world"] == WORLD
    assert [s["step"] for s in rec["steps"]] == [1, 2]
    for s in rec["steps"]:
        assert all(np.isfinite(v) for v in s["losses"].values())
    assert [e["step"] for e in rec["evals"]] == [1, 2]
    assert {"model_step_2.npz", "optimizer_step_2.npz",
            "best_video_r1_tiny.npz", "best_CIDEr_capset.npz",
            "best_accuracy_qaset.npz"} <= set(files)
    assert not any("step_1" in f or f.endswith("-tmp") for f in files)
    assert os.path.exists(os.path.join(out, "log", "hps.json"))
    # both ranks joined the one group
    for r, log in enumerate(logs):
        assert f"process {r} of {WORLD} on cpu" in log


def test_gathered_evaluation_equals_one_process(corpus, two_ranks,  # noqa: F811
                                                tmp_path):
    _, cfg_path = corpus
    out, rec, _, _ = two_ranks
    got = rec["evals"][-1]["metrics"]
    want = trun.main(["--config", str(cfg_path), "--pretrain_dir", out,
                      "--output_dir", str(tmp_path / "test"), "--device",
                      "cpu", "run_cfg.mode=testing", "--data_cfg.train",
                      "[]"])
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == pytest.approx(want[name], abs=1e-6), name


def test_resume_at_one_process_continues(corpus, two_ranks,  # noqa: F811
                                         monkeypatch):
    _, cfg_path = corpus
    out, _, _, _ = two_ranks
    seen = spy_train(monkeypatch)
    # the resumed step's evaluation is left out: the test above holds it
    rec = trun.main(["--config", str(cfg_path), "--output_dir", out,
                     "--device", "cpu", "run_cfg.resume=true",
                     "run_cfg.num_train_steps=3", "--data_cfg.val", "[]"])
    assert rec["world"] == 1
    assert rec["start_step"] == 2 and rec["end_step"] == 3
    assert [s["step"] for s in rec["steps"]] == [3]
    assert seen["optimizer"].count == 3     # the schedule's update count
    assert "model_step_3.npz" in ckpt_files(out)
