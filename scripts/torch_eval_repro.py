"""Does the testing-mode evaluation reproduce the training run's last one?

`python -m mico_tpu_torch.run` in testing mode, from a run directory, should
give the retrieval metrics of that run's last evaluation (chip_smoke.py's
phase run holds them to 1e-6). This script trains the phase's run at ViT-g
width with `--layers` blocks (4 steps, an evaluation and a save after each)
and then scores the same gallery six ways, keeping every similarity matrix
(ITC and the ITM re-rank; the phase's retrieval val set alone):

  A   the training run's last evaluation (the live model);
  A2  the live model again, in the same process, after the run returned;
  A3  the live model with `requires_grad` turned off on every parameter;
  T1  testing mode from the run directory (the checkpoint loaded);
  T2  testing mode again, in the same process;
  T3  testing mode in a fresh process.

It prints, for each pair, the largest score difference and the metrics that
differ, whether the live and the loaded weights are bitwise equal, and the
clip each evaluation drew in place of the corpus's corrupt one (the
datasets' `_resample` draws from the dataset's seeded `random.Random`, as
JAX's do). The val set holds the corrupt clip; `--clean-val` evaluates on
the corpus without it (`chip_smoke.py`'s phase run since PR 22), and the
training set keeps it either way.

Usage (on the card): python scripts/torch_eval_repro.py [--layers 10]
    [--clean-val] [--json chiprun_out/eval_repro.json]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class Hooks:
    """Record the score matrices, the evaluator and the evaluation's
    arguments of every `evaluation_mm` call."""

    def __init__(self):
        import mico_tpu_torch.evaluation as ev

        self.ev = ev
        self.calls = []
        self._recall = ev.retrieval_recall
        self._mm = ev.evaluation_registry["evaluation_mm"]

        def recall(sim, txt2vis, *a, **k):
            self.calls[-1]["sims"].append(np.array(sim, np.float64))
            return self._recall(sim, txt2vis, *a, **k)

        def mm(evaluator, val_loaders, run_cfg, step):
            self.calls.append(dict(sims=[], evaluator=evaluator,
                                   loaders=val_loaders, run_cfg=run_cfg))
            logs = self._mm(evaluator, val_loaders, run_cfg, step)
            self.calls[-1]["logs"] = logs
            return logs

        ev.retrieval_recall = recall
        ev.evaluation_registry["evaluation_mm"] = mm

        from mico_tpu_torch.data import AnnoIndexedDataset

        self.train_resamples = []
        resample = AnnoIndexedDataset._resample

        def resampled(ds, id_, what, depth):
            peek = random.Random()
            peek.setstate(ds._rng.getstate())
            drawn = dict(dataset=ds.dataset_name, training=ds.training,
                         id=id_, drawn=peek.choice(ds.idx))
            active = (not ds.training and self.calls
                      and "logs" not in self.calls[-1])
            (self.calls[-1].setdefault("resamples", []) if active
             else self.train_resamples).append(drawn)
            return resample(ds, id_, what, depth)
        AnnoIndexedDataset._resample = resampled

    def rerun(self, call: dict) -> dict:
        self.calls.append(dict(sims=[], evaluator=call["evaluator"]))
        logs = self._mm(call["evaluator"], call["loaders"], call["run_cfg"], 0)
        self.calls[-1]["logs"] = logs
        return self.calls[-1]


def ret_metrics(logs: dict) -> dict:
    return {k: v for k, v in logs["ret%tva--synthetic"].items()}


def compare(a: dict, b: dict) -> dict:
    gaps = [float(np.abs(x - y).max()) for x, y in zip(a["sims"], b["sims"])]
    ma, mb = ret_metrics(a["logs"]), ret_metrics(b["logs"])
    moved = {k: (ma[k], mb[k]) for k in ma if abs(ma[k] - mb[k]) > 1e-6}
    return dict(max_score_gap=gaps, metrics_moved=moved)


def testing_argv(argv: list, out: str) -> list:
    return argv + ["run_cfg.mode=testing", "--pretrain_dir", out,
                   "--output_dir", out + "_test"]


def test_only(argv_json: str, out: str, dump: str) -> None:
    from mico_tpu_torch.run import main as run_main

    hooks = Hooks()
    run_main(testing_argv(json.loads(argv_json), out))
    call = hooks.calls[-1]
    np.savez(dump, *call["sims"])
    with open(dump + ".json", "w") as f:
        json.dump(dict(logs=call["logs"],
                       resamples=call.get("resamples", [])), f)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=10)
    ap.add_argument("--json", default="chiprun_out/eval_repro.json")
    ap.add_argument("--test-only", nargs=3, metavar=("ARGV", "OUT", "DUMP"))
    ap.add_argument("--clean-val", action="store_true")
    args = ap.parse_args()
    if args.test_only:
        test_only(*args.test_only)
        return

    import torch

    import chip_smoke as cs
    from mico_tpu_torch.config import MiCoConfig
    from mico_tpu_torch.run import main as run_main

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    hooks = Hooks()
    root = tempfile.mkdtemp(prefix="eval_repro_")
    try:
        corpus = cs.write_run_corpus(root, seed=0)
        out = os.path.join(root, "out")
        cut = dict(MiCoConfig().eva_config.__dict__, layers=args.layers)
        argv = cs.run_argv(corpus, out)
        val = argv.index("--data_cfg.val") + 1     # the retrieval set alone
        val_cfg = json.loads(argv[val])[:1]
        val_cfg[0]["txt"] = corpus["val_txt" if args.clean_val else "txt"]
        argv[val] = json.dumps(val_cfg)
        argv += [f"model_cfg.eva_override={json.dumps(cut)}"]
        run_main(argv + [f"run_cfg.num_train_steps={cs.RUN_STEPS}",
                         f"run_cfg.valid_freq={cs.RUN_VALID_FREQ}"])
        runs = {"A": hooks.calls[-1]}
        live = runs["A"]["evaluator"].model
        runs["A2"] = hooks.rerun(runs["A"])
        grads = {n: p.requires_grad for n, p in live.named_parameters()}
        for p in live.parameters():
            p.requires_grad_(False)
        runs["A3"] = hooks.rerun(runs["A"])
        run_main(testing_argv(argv, out))
        runs["T1"] = hooks.calls[-1]
        loaded = runs["T1"]["evaluator"].model
        sd_live, sd_loaded = live.state_dict(), loaded.state_dict()
        unequal = sorted(k for k in sd_live
                         if not torch.equal(sd_live[k], sd_loaded[k]))
        dtypes = sorted({f"{k}: {sd_live[k].dtype} vs {sd_loaded[k].dtype}"
                         for k in sd_live
                         if sd_live[k].dtype != sd_loaded[k].dtype})
        run_main(testing_argv(argv, out))
        runs["T2"] = hooks.calls[-1]
        dump = os.path.join(root, "t3.npz")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--test-only", json.dumps(argv), out, dump],
                       check=True, cwd=ROOT)
        with np.load(dump) as z:
            sims = [z[f"arr_{i}"] for i in range(len(z.files))]
        with open(dump + ".json") as f:
            runs["T3"] = dict(sims=sims, **json.load(f))
        report = {
            "card": smi, "layers": args.layers, "clean_val": args.clean_val,
            "val_resamples": {k: r.get("resamples", [])
                              for k, r in runs.items()},
            "train_resamples": hooks.train_resamples,
            "requires_grad_on_live": sum(grads.values()),
            "parameters": len(grads),
            "live_vs_loaded_unequal": unequal[:50],
            "n_unequal": len(unequal), "dtype_differences": dtypes[:20],
            "metrics": {k: ret_metrics(r["logs"]) for k, r in runs.items()},
            "pairs": {f"{a} vs {b}": compare(runs[a], runs[b])
                      for a, b in (("A", "A2"), ("A", "A3"), ("A", "T1"),
                                   ("A2", "A3"), ("A3", "T1"), ("T1", "T2"),
                                   ("T1", "T3"))}}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k, drawn in report["val_resamples"].items():
        print(f"{k}: the corrupt val clip replaced by "
              f"{[d['drawn'] for d in drawn]}")
    for pair, c in report["pairs"].items():
        print(f"{pair}: max |d score| {c['max_score_gap']}, metrics moved "
              f"{c['metrics_moved']}")
    print(f"live vs loaded weights: {report['n_unequal']} of "
          f"{len(sd_live)} entries differ {report['live_vs_loaded_unequal'][:8]}"
          f"; dtypes {report['dtype_differences'][:4]}; requires_grad on "
          f"{report['requires_grad_on_live']} of {report['parameters']}")
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(json.dumps({k: v for k, v in report.items() if k != "metrics"},
                     default=str))


if __name__ == "__main__":
    main()
