#!/usr/bin/env python3
"""Checkpoint loading of the port by stage, at MiCo-ViT-g's full size on
one CUDA card.

    python3 scripts/torch_load_bench.py [--repeat 3] [--dtype float32]
        [--profile] [--backend pt|orbax]

Writes the released layout that `chip_smoke.py`'s demo phase writes (all
897 entries of `tests/fixtures/mico_vit_g_manifest.json` in fp16, drawn
from seed 0) to a temporary directory, then loads it `--repeat` times
through `train/checkpoints.py` and `convert.py`, timing each stage on the
host clock: reading the state_dict (`load_torch_state_dict`, memory-mapped),
converting it to the parameter tree (`models.mico.mico_from_torch`: the
transposed views, the depth stacks, the resizes) and placing the tree on
the card in `--dtype` (`convert.mico_from_jax`, ending in a synchronize),
with the process's resident set after each stage and its peak over the
load. `--profile` also prints each placement's 12 costliest functions by
their own time (cProfile). Prints the card's name and power limit first and
one JSON line of the numbers last.

`--backend orbax` instead draws the same model's fp32 weights on the card,
writes them as the port's `.orbax` (`ModelSaver(backend="orbax")`: zarr
arrays on an OCDBT store, each a stored zstd frame a chunk), and times each
load by stage: the OCDBT walk (`orbax_format.Checkpoint`: the manifest, the
b-tree, `_METADATA`), the zstd decode of every chunk into its host tensor
on the host's threads (`Checkpoint.read`, which maps the data file), and
the placement on the card (`convert.mico_from_jax`); with the write's
seconds and GB/s.
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import json
import pstats
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--backend", default="pt", choices=["pt", "orbax"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_load_bench: needs a CUDA card", file=sys.stderr)
        return 2
    if args.backend == "orbax":
        return orbax_bench(args)
    import chip_smoke as cs
    from mico_tpu_torch.config import mico_config_from_dict
    from mico_tpu_torch.convert import mico_from_jax
    from mico_tpu_torch.models.mico import mico_from_torch
    from mico_tpu_torch.train.checkpoints import load_torch_state_dict

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    manifest = json.loads((ROOT / cs.MANIFEST).read_text())
    cfg = mico_config_from_dict(cs.DEMO_MODEL_CFG)
    dtype = getattr(torch, args.dtype)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        files = cs.write_demo_inputs(tmp, 0, manifest, cs.DEMO_MODEL_CFG)
        path = Path(files["pretrain_dir"]) / "ckpt" / \
            f"model_step_{cs.DEMO_STEP}.pt"
        torch.cuda.synchronize()
        for i in range(args.repeat):
            gc.collect()
            torch.cuda.empty_cache()
            rss = cs.RssPeak()
            run = {"rss_before_gib": rss.start / 2**30}
            t0 = time.perf_counter()
            sd = load_torch_state_dict(str(path))
            run["read_s"] = time.perf_counter() - t0
            run["rss_read_gib"] = rss.now() / 2**30
            t0 = time.perf_counter()
            tree = mico_from_torch(sd, cfg)
            run["convert_s"] = time.perf_counter() - t0
            run["rss_convert_gib"] = rss.now() / 2**30
            prof = cProfile.Profile() if args.profile else None
            t0 = time.perf_counter()
            if prof:
                prof.enable()
            model = mico_from_jax(tree, cfg, device="cuda", dtype=dtype)
            torch.cuda.synchronize()
            run["place_s"] = time.perf_counter() - t0
            if prof:
                prof.disable()
                pstats.Stats(prof).sort_stats("tottime").print_stats(12)
            run["rss_peak_gib"] = rss.close() / 2**30
            run["total_s"] = run["read_s"] + run["convert_s"] + run["place_s"]
            run["params"] = sum(p.numel() for p in model.parameters())
            print(f"run {i}: read {run['read_s']:.3f} s, convert "
                  f"{run['convert_s']:.3f} s, place {run['place_s']:.3f} s "
                  f"(total {run['total_s']:.3f} s); RSS before "
                  f"{run['rss_before_gib']:.2f} GiB, after read "
                  f"{run['rss_read_gib']:.2f}, after convert "
                  f"{run['rss_convert_gib']:.2f}, peak "
                  f"{run['rss_peak_gib']:.2f} [{card}]", flush=True)
            runs.append(run)
            del sd, tree, model
    med = {k: statistics.median(r[k] for r in runs)
           for k in ("read_s", "convert_s", "place_s", "total_s")}
    print(json.dumps({"card": card, "dtype": args.dtype,
                      "checkpoint_bytes": files["ckpt_bytes"],
                      "median": med, "runs": runs}))
    return 0


def orbax_bench(args) -> int:
    import chip_smoke as cs
    from mico_tpu_torch.config import mico_config_from_dict
    from mico_tpu_torch.convert import mico_from_jax
    from mico_tpu_torch.models.mico import MiCo
    from mico_tpu_torch.train import orbax_format
    from mico_tpu_torch.train.checkpoints import ModelSaver

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    cfg = mico_config_from_dict(cs.DEMO_MODEL_CFG)
    dtype = getattr(torch, args.dtype)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        model = MiCo(cfg, device="cuda", seed=0, init_device="cuda")
        torch.cuda.synchronize()
        rss = cs.RssPeak()
        t0 = time.perf_counter()
        ModelSaver(tmp, backend="orbax").save(1, model)
        write_s = time.perf_counter() - t0
        write_rss = rss.close()
        del model
        gc.collect()
        torch.cuda.empty_cache()
        path = str(Path(tmp) / "ckpt" / "model_step_1.orbax")
        nbytes = cs.dir_bytes(path)
        print(f"write: {nbytes / 1e9:.3f} GB in {write_s:.3f} s "
              f"({nbytes / 1e9 / write_s:.3f} GB/s); RSS peak "
              f"{write_rss / 2**30:.2f} GiB [{card}]", flush=True)
        for i in range(args.repeat):
            gc.collect()
            torch.cuda.empty_cache()
            rss = cs.RssPeak()
            run = {"rss_before_gib": rss.start / 2**30}
            t0 = time.perf_counter()
            ckpt = orbax_format.Checkpoint(path)
            names = ckpt.names()
            for n in names:
                ckpt.array(n)
            run["walk_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            tree = orbax_format.unflatten(
                [(ckpt.keys_of(n), ckpt.read(n)) for n in names])
            run["decode_s"] = time.perf_counter() - t0
            run["rss_decode_gib"] = rss.now() / 2**30
            run["chunks"] = len(ckpt.decoded)
            t0 = time.perf_counter()
            model = mico_from_jax(tree, cfg, device="cuda", dtype=dtype)
            torch.cuda.synchronize()
            run["place_s"] = time.perf_counter() - t0
            run["rss_peak_gib"] = rss.close() / 2**30
            run["total_s"] = run["walk_s"] + run["decode_s"] + run["place_s"]
            run["read_gb_s"] = nbytes / 1e9 / (run["walk_s"] + run["decode_s"])
            print(f"run {i}: OCDBT walk {run['walk_s']:.3f} s, decode "
                  f"{run['chunks']} chunks {run['decode_s']:.3f} s "
                  f"({run['read_gb_s']:.3f} GB/s with the walk), place "
                  f"{run['place_s']:.3f} s (total {run['total_s']:.3f} s); "
                  f"RSS before {run['rss_before_gib']:.2f} GiB, after decode "
                  f"{run['rss_decode_gib']:.2f}, peak "
                  f"{run['rss_peak_gib']:.2f} [{card}]", flush=True)
            runs.append(run)
            del tree, model, ckpt
    med = {k: statistics.median(r[k] for r in runs)
           for k in ("walk_s", "decode_s", "place_s", "total_s", "read_gb_s")}
    print(json.dumps({"card": card, "backend": "orbax", "dtype": args.dtype,
                      "checkpoint_bytes": nbytes, "write_s": write_s,
                      "write_gb_s": nbytes / 1e9 / write_s,
                      "median": med, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
