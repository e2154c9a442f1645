"""The port's train/test entry, `python -m mico_tpu_torch.run`, end to end on
the CPU (`--device cpu`) at the tiny config, on a corpus written in the
test (cv2 JPEGs, 16 kHz WAVs, captions, questions and answers):

  - training writes `log/hps.json`, `ckpt/model_step_N.npz`, the optimizer
    file and `best_*` snapshots, and JAX's `load_pytree_npz` reads the
    model file into a tree equal to `params_to_jax` of the trained model;
  - `run_cfg.mode=testing` from that run as a `pretrain_dir` gives JAX's
    `mico_tpu.run.main` metrics on the same directory;
  - resume continues the numbering and the optimizer's update count, and
    deletes the old step only after the new one is committed; a save that
    fails mid-write leaves the previous checkpoint committed;
  - gradient accumulation (k = 2 over two micro-batches) equals one step on
    their union (rates 0, draws injected);
  - the caption-generation config's testing shape, `param_dtype`, and what
    the port refuses (no card, parallelism), and the orbax backend's save
    and resume.
"""

import json
import os
import shutil
import wave as wave_mod

import numpy as np
import pytest
import torch

from mico_tpu.train.checkpoints import load_pytree_npz
import mico_tpu_torch.pipeline as tpipeline
import mico_tpu_torch.run as trun
import mico_tpu_torch.train.checkpoints as tckpt
from mico_tpu_torch.convert import params_to_jax
from mico_tpu_torch.models.mico import MiCo
from mico_tpu_torch.train.objectives import Draws
from mico_tpu_torch.train.optim import OptimConfig, build_optimizer
from mico_tpu_torch.train.train_step import make_train_step

from torch_port_common import TINY, configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_VOCAB = os.path.join(ROOT, "mico_tpu", "assets", "vocab.txt")
RES = 28


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("run_corpus")
    (root / "img").mkdir()
    (root / "wav").mkdir()
    (root / "frames").mkdir()
    rng = np.random.default_rng(0)
    annos = []
    for i in range(8):
        cv2.imwrite(str(root / "img" / f"v{i}.jpg"),
                    rng.integers(0, 255, (40, 44, 3), dtype=np.uint8))
        fdir = root / "frames" / f"v{i}"
        fdir.mkdir()
        for k in range(4):
            cv2.imwrite(str(fdir / f"{k}.jpg"),
                        rng.integers(0, 255, (30, 36, 3), dtype=np.uint8))
        w = (rng.standard_normal(8000) * 0.1).clip(-1, 1)
        with wave_mod.open(str(root / "wav" / f"v{i}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes((w * 32767).astype(np.int16).tobytes())
        annos.append({"video_id": f"v{i}", "caption": f"photo of item {i}",
                      "question": "what number", "answer": str(i)})
    (root / "img" / "bad.jpg").write_bytes(b"not a jpeg")
    annos.append({"video_id": "bad", "caption": "broken", "question": "what",
                  "answer": "none"})
    (root / "annos.json").write_text(json.dumps(annos))
    d = {"txt": str(root / "annos.json"), "vision": str(root / "img"),
         "vision_format": "image_rawimage", "n_workers": 2,
         "type": "annoindexed"}
    audio = {"audio": str(root / "wav"), "audio_sample_num": 2}
    model_cfg = {
        "vision_resolution": RES, "audio_melbins": RES,
        "audio_target_length": RES, "audio_encoder_type": "shared",
        "max_caption_len": 8, "beam_size": 2, "compute_dtype": "float32",
        "use_flash_attention": True, "max_vision_sample_num": 1,
        "max_audio_sample_num": 2, "contra_dim": 32, "itm_rerank_num": 4,
        "eva_override": dict(TINY["eva"]),
        "bert_override": dict(TINY["bert"])}
    cfg = {
        "run_cfg": {"seed": 0, "num_train_steps": 2, "valid_freq": 1,
                    "log_every": 1, "learning_rate": 1e-3,
                    "first_eval": False, "itm_rerank": True},
        "model_cfg": model_cfg,
        "data_cfg": {
            "train": [{**d, **audio, "name": "tiny",
                       "task": "ret%tva_cap%tva", "training": True,
                       "batch_size": 4, "steps": 2}],
            # vision only: JAX's AudioMapper refuses the shared tower's
            # audio, and the testing-mode comparison runs these in JAX
            "val": [{**d, "name": "tiny", "task": "ret%tv",
                     "training": False, "batch_size": 4},
                    {**d, "name": "capset", "task": "cap%tv",
                     "training": False, "batch_size": 4},
                    {**d, "name": "qaset", "task": "qa%tv",
                     "training": False, "batch_size": 4}],
        },
    }
    path = root / "config.json"
    path.write_text(json.dumps(cfg))
    return root, path


def spy_train(monkeypatch):
    """Capture the model `run.main` trains."""
    seen = {}
    orig = tpipeline.train

    def train(cfg, model, optimizer, *a, **kw):
        seen.update(model=model, optimizer=optimizer, cfg=cfg)
        return orig(cfg, model, optimizer, *a, **kw)

    monkeypatch.setattr(trun, "train", train)
    return seen


def ckpt_files(out):
    return sorted(os.listdir(os.path.join(out, "ckpt")))


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """Two training steps through the CLI, then two more on resume."""
    root, cfg_path = corpus
    out = str(tmp_path_factory.mktemp("run_out"))
    mp = pytest.MonkeyPatch()
    try:
        seen = spy_train(mp)
        base = ["--config", str(cfg_path), "--output_dir", out,
                "--device", "cpu"]
        rec = trun.main(base)
        state = {k: v.clone() for k, v in seen["model"].state_dict().items()}
        kept = str(tmp_path_factory.mktemp("kept") / "model_step_2.npz")
        shutil.copy(os.path.join(out, "ckpt", "model_step_2.npz"), kept)
        first = dict(record=rec, files=ckpt_files(out), kept=kept,
                     tree=params_to_jax(state, seen["cfg"]), state=state,
                     cfg=seen["cfg"], count=seen["optimizer"].count)
        events = []
        mp.setattr(tckpt, "_commit", lambda tmp, final: (
            events.append(("commit", os.path.basename(final))),
            os.replace(tmp, final)))
        mp.setattr(tckpt, "_remove", lambda p: (
            events.append(("remove", os.path.basename(p))), os.remove(p)))
        rec2 = trun.main(base + ["run_cfg.num_train_steps=4",
                                 "run_cfg.resume=true"])
        second = dict(record=rec2, files=ckpt_files(out), events=events,
                      count=seen["optimizer"].count,
                      state={k: v.clone() for k, v in
                             seen["model"].state_dict().items()})
    finally:
        mp.undo()
    return out, first, second


def test_training_writes_the_run_directory(trained):
    out, first, _ = trained
    rec = first["record"]
    assert [s["step"] for s in rec["steps"]] == [1, 2]
    for s in rec["steps"]:
        assert all(np.isfinite(v) for v in s["losses"].values())
        assert s["data_wait_s"] >= 0 and s["step_s"] > 0
    # valid_steps = num_train_steps // valid_freq - 1 = 1: eval every step
    assert [e["step"] for e in rec["evals"]] == [1, 2]
    assert set(rec["evals"][0]["metrics"]) == {
        "ret%tv--tiny", "cap%tv--capset", "qa%tv--qaset"}
    assert os.path.exists(os.path.join(out, "log", "hps.json"))
    assert os.path.exists(os.path.join(out, "log", "log.txt"))
    assert {"model_step_2.npz", "optimizer_step_2.npz",
            "best_video_r1_tiny.npz", "best_CIDEr_capset.npz",
            "best_accuracy_qaset.npz"} <= set(first["files"])
    assert not any("step_1" in f or f.endswith("-tmp")
                   for f in first["files"])
    assert first["count"] == 2


def test_jax_reads_the_port_model_file(trained):
    """JAX's npz reader gives params_to_jax of the trained model (the file
    of step 2, kept before the resume replaced it), and the port reads it
    back into the same weights."""
    _, first, _ = trained
    got = load_pytree_npz(first["kept"])

    def compare(g, w, where=""):
        if isinstance(w, dict):
            assert g.keys() == w.keys(), where
            for k in w:
                compare(g[k], w[k], f"{where}/{k}")
        else:
            assert np.asarray(g).dtype == np.float32, where
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=where)

    compare(got, first["tree"])
    back = MiCo(first["cfg"], device="cpu", init_weights=False).to_empty(
        device="cpu")
    tckpt.load_model_npz(first["kept"], back)
    for k, v in back.state_dict().items():
        assert torch.equal(v, first["state"][k]), k


def test_resume_continues_the_numbering(trained):
    out, first, second = trained
    rec = second["record"]
    assert rec["start_step"] == 2 and rec["end_step"] == 4
    assert [s["step"] for s in rec["steps"]] == [3, 4]
    assert second["count"] == 4            # the LR schedule's update count
    files = second["files"]
    assert "model_step_4.npz" in files and "optimizer_step_4.npz" in files
    assert not any("step_2" in f or "step_3" in f for f in files)
    # every step's files are committed before the previous step's go
    ev = second["events"]
    for step in (3, 4):
        commit = ev.index(("commit", f"model_step_{step}.npz"))
        removed = ev.index(("remove", f"model_step_{step - 1}.npz"))
        assert commit < removed
        assert ev.index(("commit", f"optimizer_step_{step}.npz")) < commit


def test_testing_mode_matches_jax(corpus, trained, tmp_path):
    """mode=testing with the trained run as pretrain_dir: the port's
    metrics equal JAX's `mico_tpu.run.main` on the same directory."""
    from mico_tpu.run import main as jax_main

    root, cfg_path = corpus
    out, _, _ = trained
    # no train set: JAX builds its loaders in testing mode too, and its
    # AudioMapper refuses the shared tower's audio
    argv = ["--config", str(cfg_path), "--pretrain_dir", out,
            "run_cfg.mode=testing", "--data_cfg.train", "[]"]
    got = trun.main(argv + ["--output_dir", str(tmp_path / "t"),
                            "--device", "cpu"])
    # JAX's initialize switches JAX's PRNG to `rbg` unless told otherwise
    want = jax_main(argv + ["--output_dir", str(tmp_path / "j"),
                            "--vocab", JAX_VOCAB,
                            "run_cfg.rng_impl=threefry2x32"])
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == pytest.approx(
            {k: float(v) for k, v in want[name].items()}, abs=1e-9), name


def test_failed_save_keeps_the_committed_checkpoint(corpus, tmp_path,
                                                    monkeypatch):
    """A save that dies mid-write (after some leaves) leaves the previous
    step's files committed and loadable, and no scratch file behind."""
    root, cfg_path = corpus
    out = str(tmp_path / "out")
    base = ["--config", str(cfg_path), "--output_dir", out, "--device", "cpu",
            "run_cfg.num_train_steps=2", "run_cfg.valid_freq=2"]
    trun.main(base)           # valid_steps 1: saves at steps 1 and 2
    before = ckpt_files(out)
    assert "model_step_2.npz" in before
    calls = {"n": 0}
    orig = tckpt._host_bytes

    def dying(t):
        calls["n"] += 1
        if calls["n"] > 5:
            raise OSError("disk full")
        return orig(t)

    monkeypatch.setattr(tckpt, "_host_bytes", dying)
    with pytest.raises(OSError, match="disk full"):
        trun.main(base + ["run_cfg.num_train_steps=3", "run_cfg.resume=true"])
    assert ckpt_files(out) == before
    monkeypatch.undo()
    _, tcfg = configs(max_vision_sample_num=1, max_audio_sample_num=2,
                      contra_dim=32)
    model = MiCo(tcfg, device="cpu", init_weights=False).to_empty(
        device="cpu")
    assert tckpt.resume_latest(out, model) == 2


def micro_batches(b: int = 4, seed: int = 0):
    """A cap%tv batch of b items and its caption masks: every row masks
    the same number of tokens, so the mean loss over two halves is the
    loss over their union."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1000, 20000, (b, 8)).astype(np.int64)
    ids[:, 0], ids[:, -1] = 101, 102
    mask = np.ones((b, 8), np.int64)
    labels = np.full((b, 8), -100, np.int64)
    masked = ids.copy()
    for i in range(b):
        pos = rng.choice(np.arange(1, 8), 3, replace=False)
        labels[i, pos] = ids[i, pos]
        masked[i, pos] = 103
    pixels = rng.standard_normal((b, 1, 3, RES, RES)).astype(np.float32)
    t = torch.from_numpy
    return {"vision_pixels": t(pixels), "caption_ids": t(ids),
            "caption_mask": t(mask)}, (t(masked), t(labels))


def test_gradient_accumulation_equals_the_union_step():
    """k = 2 over two micro-batches: no update after the first, one after
    the second, with the mean gradient (within 1e-6 of the union's) and
    the same parameters as one step on the union (within 1e-6); the
    schedule counts updates."""
    _, tcfg = configs(max_vision_sample_num=1,
                      bert={"hidden_dropout_prob": 0.0,
                            "attention_probs_dropout_prob": 0.0},
                      eva={"drop_path_rate": 0.0})
    batch, (masked, labels) = micro_batches()
    opt_cfg = OptimConfig(num_train_steps=2, warmup_ratio=0.5, grad_norm=1e3)
    grads = {}

    def run(k):
        model = MiCo(tcfg, device="cpu", seed=3)
        opt = build_optimizer(model, opt_cfg, accum_steps=k)
        step = make_train_step(tcfg, opt, "cap%tv")
        clip = opt.clip_

        def record():
            norm = clip()        # grad_norm 1e3: no scaling
            grads[k] = {n: p.grad.clone() for n, p in zip(opt.names,
                                                          opt.params)}
            return norm

        opt.clip_ = record
        halves = [slice(0, 2), slice(2, 4)] if k == 2 else [slice(0, 4)]
        for update in range(2):
            for i, h in enumerate(halves):
                before = {n: p.clone() for n, p in model.named_parameters()}
                step(model, {n: v[h] for n, v in batch.items()},
                     torch.Generator().manual_seed(0),
                     draws=Draws(masks=[(masked[h], labels[h])]))
                unchanged = all(torch.equal(before[n], p)
                                for n, p in model.named_parameters())
                assert unchanged == (i < len(halves) - 1 or update == 0)
            assert opt.count == update + 1 and opt.mini_step == 0
        return dict(model.named_parameters())

    one, two = run(1), run(2)
    for n in grads[1]:
        np.testing.assert_allclose(grads[2][n].numpy(), grads[1][n].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    for n in one:
        np.testing.assert_allclose(two[n].detach().numpy(),
                                   one[n].detach().numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)


def test_bf16_params_train_with_bf16_moments(corpus, tmp_path, monkeypatch):
    """run_cfg.param_dtype=bfloat16 casts the parameters, and the AdamW
    moments follow them (torch's AdamW holds bf16 moments, as optax's
    do; nothing to refuse)."""
    root, cfg_path = corpus
    seen = spy_train(monkeypatch)
    rec = trun.main(["--config", str(cfg_path), "--output_dir",
                     str(tmp_path / "bf"), "--device", "cpu",
                     "run_cfg.param_dtype=bfloat16",
                     "run_cfg.num_train_steps=1", "run_cfg.valid_freq=1"])
    assert all(np.isfinite(v) for v in rec["steps"][0]["losses"].values())
    assert {p.dtype for p in seen["model"].parameters()} == {torch.bfloat16}
    state = seen["optimizer"].torch_optimizer.state
    assert state and all(s["exp_avg"].dtype == torch.bfloat16
                         for s in state.values())


def test_caption_generation_config_testing_mode(corpus, tmp_path):
    """configs/caption-generation-vision.json's shape (testing mode,
    captioner_mode, 3 samples a clip) on frame directories, with the
    shared audio tower named on the command line (the config inherits
    BEATs, which the port does not have)."""
    root, cfg_path = corpus
    model_cfg = json.loads(cfg_path.read_text())["model_cfg"]
    # the corrupt image has no frame directory: an annotation file without it
    annos = [a for a in json.loads((root / "annos.json").read_text())
             if a["video_id"] != "bad"]
    (tmp_path / "annos.json").write_text(json.dumps(annos))
    val = [{"type": "annoindexed", "training": False, "name": "clips",
            "txt": str(tmp_path / "annos.json"),
            "vision": str(root / "frames"), "vision_format": "video_frame",
            "vision_sample_num": 2, "task": "cap%tv", "n_workers": 2,
            "batch_size": 4}]
    argv = ["--config", os.path.join(ROOT, "configs",
                                     "caption-generation-vision.json"),
            "--output_dir", str(tmp_path), "--device", "cpu",
            "--data_cfg.val", json.dumps(val)]
    argv += [f"model_cfg.{k}={json.dumps(v)}" for k, v in model_cfg.items()]
    # the config sets model_cfg.generate_nums, the evaluator reads
    # run_cfg's (JAX's evaluation_mm): one sample a clip, as in JAX
    for over, n in (([], 1), (["run_cfg.generate_nums=3"], 3)):
        logs = trun.main(argv + over)
        assert logs == {"cap%tv--clips": {"num_annotated": 8.0}}
        with open(tmp_path / "annotations_step0_cap%tv--clips.json") as f:
            ann = json.load(f)
        assert len(ann) == 8 and all(len(a["tv_captions"]) == n
                                     for a in ann)


def test_refusals(corpus, tmp_path, monkeypatch):
    root, cfg_path = corpus
    base = ["--config", str(cfg_path), "--output_dir", str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trun.main(base)             # the default device is the card
    cpu = base + ["--device", "cpu"]
    # checkpoint_backend=orbax is no longer refused: it saves `.orbax`
    # directories and resumes from them (model, moments and update count)
    orbax = cpu + ["run_cfg.checkpoint_backend=orbax", "--data_cfg.val", "[]"]
    trun.main(orbax)
    assert ckpt_files(str(tmp_path)) == ["model_step_2.orbax",
                                         "optimizer_step_2.orbax"]
    seen = spy_train(monkeypatch)
    rec = trun.main(orbax + ["run_cfg.resume=true",
                             "run_cfg.num_train_steps=3"])
    assert rec["start_step"] == 2 and rec["end_step"] == 3
    assert seen["optimizer"].count == 3
    assert ckpt_files(str(tmp_path)) == ["model_step_3.orbax",
                                         "optimizer_step_3.orbax"]
    monkeypatch.undo()
    # tensor and pipeline parallelism are ported: model 2 and 2 stages take
    # two processes, and one process cannot hold their mesh
    for over in ("run_cfg.model_parallel=2", "run_cfg.pipeline_stages=2"):
        with pytest.raises(ValueError, match="model=2 does not divide 1"):
            trun.main(cpu + [over])
    # a multi-process run needs torchrun's environment or JAX's keys
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun's environment"):
        trun.main(cpu + ["run_cfg.multihost=true"])
