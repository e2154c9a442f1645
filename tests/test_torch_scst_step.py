"""One SCST step of the port (`mico_tpu_torch/train/scst.py`
`make_scst_step`) against JAX's on the CPU at the tiny fp32 config,
decoder-only and with `finetune_encoder` (JAX's sampled tokens injected:
loss, rewards and the updated parameters), the rollout's feature route,
and `python -m mico_tpu_torch.run --device cpu` on an `scst%tv` corpus.
The rest of SCST (the differentiated routes, `generate_scst`, the
REINFORCE gradient) is `tests/test_torch_scst.py`'s; the two files run on
separate workers."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu import generation as jgen
from mico_tpu.train import objectives as jobj
from mico_tpu.train import optim as joptim
from mico_tpu.train import scst as jscst
import mico_tpu_torch.run as trun
from mico_tpu_torch.config import BERT_SEP_ID
from mico_tpu_torch.convert import params_from_jax
from mico_tpu_torch.ops import flash_attention as tfa
from mico_tpu_torch.train import optim, scst

from test_torch_scst import SCST_SEP_BIAS, TokStub
from torch_port_common import TINY, close, configs, no_launch, \
    perturbed_params, port_model, t, to_numpy

# Adam's eps at 1e-3 and no weight decay: updates comparable at 1e-5
STEP_OPT = dict(learning_rate=1e-2, clip_lr=1e-2, num_train_steps=100,
                warmup_ratio=0.0, weight_decay=0.0, eps=1e-3)


def _batch(rng, b=4, n=2):
    return {"vision_pixels": rng.standard_normal(
        (b, n, 3, 28, 28)).astype(np.float32)}


@pytest.fixture(scope="module")
def step_setup():
    """The two step cases' shared inputs, made once: the tiny MiCo's
    params ([SEP]'s MLM bias raised), a batch, JAX's sampled tokens of its
    first rollout, references built from them (so advantages are
    non-zero), and JAX's optimizer with its initial state."""
    jcfg, tcfg = configs(max_vision_sample_num=2, max_caption_len=6)
    params = perturbed_params(jcfg, seed=4)
    head = params["bert"]["mlm_head"]
    head["decoder_b"] = head["decoder_b"].at[BERT_SEP_ID].add(
        1.8 + SCST_SEP_BIAS)
    batch = _batch(np.random.default_rng(8))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(21)
    cond = jobj.compute_features(params, jcfg, jbatch, "v")[
        "condition_feats_v"]
    jtok, _ = jgen.generate_scst(params["bert"], jcfg.bert_config, cond,
                                 max_new_tokens=6,
                                 rng=jax.random.fold_in(key, 0),
                                 use_cache=True)
    refs = TokStub().batch_decode(np.asarray(jtok))
    refs = [[r, r + " 7"] if i % 2 else r for i, r in enumerate(refs)]
    jopt = joptim.build_optimizer(params, joptim.OptimConfig(**STEP_OPT))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, batch=batch,
                jbatch=jbatch, key=key, jtok=jtok, refs=refs, jopt=jopt,
                jopt_state=jopt.init(params))


@pytest.mark.parametrize("finetune", [False, True],
                         ids=["decoder_only", "finetune_encoder"])
def test_scst_step_matches_jax(step_setup, finetune):
    """One step of each package's `make_scst_step` from the same params,
    batch and references (the JAX model's own first sample, so advantages
    are non-zero), JAX's sampled tokens injected: loss, rewards and every
    updated parameter agree. Weight decay 0: without the finetune the tower
    gets no gradient and stays exactly where it was."""
    s = step_setup
    params, batch, refs, jtok = s["params"], s["batch"], s["refs"], s["jtok"]
    tok, oc, tcfg = TokStub(), STEP_OPT, s["tcfg"]
    jstep = jscst.make_scst_step(s["jcfg"], s["jopt"], "scst%tv", tok,
                                 donate=False, finetune_encoder=finetune)
    jp, _, jout = jstep(params, s["jopt_state"], s["jbatch"], s["key"], refs)

    model = port_model(params, tcfg)
    topt = optim.build_optimizer(model, optim.OptimConfig(**oc))
    step = scst.make_scst_step(tcfg, topt, "scst%tv", tok,
                               finetune_encoder=finetune)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    timings = {}
    out = no_launch(lambda: step(
        model, {k: t(v) for k, v in batch.items()}, torch.Generator(), refs,
        draws={"v": t(np.asarray(jtok)).long()}, timings=timings))
    assert sorted(timings) == sorted(["rollout_encoder", "sample_decode",
                                      "greedy_decode", "reward", "update",
                                      "optimizer"])
    for k in ("loss_scst", "reward_sample", "reward_greedy"):
        close(out[k], float(jout[k]), dict(rtol=1e-5, atol=1e-6))
    assert float(jout["reward_sample"]) != float(jout["reward_greedy"])
    want = params_from_jax(to_numpy(jp), tcfg)
    for name, p in model.named_parameters():
        close(p.detach(), want[name], dict(rtol=1e-5, atol=1e-5))
    tower = [n for n in before if n.startswith("vision_encoder.")]
    moved = {n: float((model.state_dict()[n] - before[n]).abs().max())
             for n in before}
    assert max(moved[n] for n in before if n.startswith("bert.")) > 1e-3
    if finetune:
        assert max(moved[n] for n in tower) > 1e-3
    else:
        assert max(moved[n] for n in tower) == 0.0


def test_scst_step_rollout_feature_route(step_setup, monkeypatch):
    """The rollout runs the towers under no_grad with no train generator
    (the inference route); with `finetune_encoder` the update runs them
    again under grad, on K1's differentiated route."""
    _, tcfg = configs(max_vision_sample_num=2, max_caption_len=4)
    model = port_model(step_setup["params"], tcfg)
    topt = optim.build_optimizer(model, optim.OptimConfig(num_train_steps=5))
    calls = []
    real = tfa.fused_ln_qkv_self_attention

    def spy(x, *a, **kw):
        calls.append(torch.is_grad_enabled())
        return real(x, *a, **kw)

    monkeypatch.setattr(tfa, "fused_ln_qkv_self_attention", spy)
    batch = {k: t(v) for k, v in _batch(np.random.default_rng(2), 2).items()}
    for finetune, want in ((False, [False] * 2), (True, [False, True] * 2)):
        calls.clear()
        step = scst.make_scst_step(tcfg, topt, "scst%tv", TokStub(),
                                   finetune_encoder=finetune)
        out = step(model, batch, torch.Generator().manual_seed(0),
                   ["1 2", "3"])
        assert np.isfinite(out["loss_scst"].item())
        assert sorted(calls) == sorted(want)


# ---------------------------------------------------------------------------
# the train entry
# ---------------------------------------------------------------------------


def test_run_trains_an_scst_task(tmp_path):
    """`python -m mico_tpu_torch.run --device cpu` over an `scst%tv` corpus
    (images with one or two reference captions), no validation set: two
    steps with finite losses and rewards, the BERT weights moved, the
    checkpoint written."""
    import cv2

    rng = np.random.default_rng(0)
    (tmp_path / "img").mkdir()
    annos = []
    for i in range(4):
        cv2.imwrite(str(tmp_path / "img" / f"v{i}.jpg"),
                    rng.integers(0, 255, (40, 44, 3), dtype=np.uint8))
        caption = (f"a photo of item {i}" if i % 2 else
                   [f"a photo of item {i}", f"an image of thing {i}"])
        annos.append({"video_id": f"v{i}", "caption": caption})
    (tmp_path / "annos.json").write_text(json.dumps(annos))
    model_cfg = {
        "vision_resolution": 28, "max_caption_len": 5,
        "audio_encoder_type": "shared",
        "compute_dtype": "float32", "use_flash_attention": True,
        "max_vision_sample_num": 1, "contra_dim": 32,
        "eva_override": dict(TINY["eva"]),
        "bert_override": dict(TINY["bert"])}
    cfg = {"run_cfg": {"seed": 0, "num_train_steps": 2, "valid_freq": 2,
                       "log_every": 1, "learning_rate": 1e-3,
                       "warmup_ratio": 0.0, "first_eval": False},
           "model_cfg": model_cfg,
           "data_cfg": {"train": [{
               "type": "annoindexed", "txt": str(tmp_path / "annos.json"),
               "vision": str(tmp_path / "img"),
               "vision_format": "image_rawimage", "n_workers": 1,
               "name": "tiny", "task": "scst%tv", "training": True,
               "batch_size": 4, "steps": 2}]}}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    seen = {}
    real = trun.train

    def train(cfg_, model, *a, **kw):
        seen["before"] = {k: v.clone() for k, v in model.state_dict().items()}
        seen["model"] = model
        return real(cfg_, model, *a, **kw)

    out = tmp_path / "out"
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(trun, "train", train)
        rec = trun.main(["--config", str(path), "--output_dir", str(out),
                         "--device", "cpu"])
    finally:
        mp.undo()
    assert [s["task"] for s in rec["steps"]] == ["scst%tv"] * 2
    for s in rec["steps"]:
        assert sorted(s["losses"]) == ["loss_scst", "reward_greedy",
                                       "reward_sample"]
        assert all(np.isfinite(v) for v in s["losses"].values())
    after = seen["model"].state_dict()
    assert max(float((after[k] - v).abs().max())
               for k, v in seen["before"].items() if k.startswith("bert.")) > 0
    assert (out / "ckpt" / "model_step_2.npz").exists()


