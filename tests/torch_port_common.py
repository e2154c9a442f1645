"""Shared set-up of the port's CPU tests (`tests/test_torch_*.py`): the tiny
MiCo config (EVA 28 px / 14, 2 layers, width 64, head width 32; BERT 64
wide, 2 layers, 2 heads) built in both packages, JAX params with every leaf
perturbed (so LN affines, biases and folds are not trivial), and the port's
model holding the same weights.

The port runs in fp32 on the CPU; inputs come from
`np.random.default_rng(seed)`.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mico_tpu import config as jax_config
from mico_tpu.models import mico as jax_mico
from mico_tpu_torch import config as torch_config
from mico_tpu_torch.convert import mico_from_jax

# pytest-xdist runs the suite in several workers on one host: torch's
# OpenMP pool at the host's cores divided by the workers keeps their
# threads from spinning against each other, which with every worker at
# every core about doubled the port tests' time
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

# per-op and whole-model tolerances (fp32 on the CPU; the two frameworks
# sum in other orders)
OP_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)

TINY = dict(
    eva=dict(image_size=28, patch_size=14, layers=2, width=64, head_width=32,
             embed_dim=64),
    bert=dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=128, encoder_width=64),
    mico=dict(vision_resolution=28, contra_dim=32, compute_dtype="float32",
              use_flash_attention=True),
)


def configs(eva=None, bert=None, **mico):
    """(JAX MiCoConfig, port MiCoConfig) of the tiny model, with overrides."""
    e = {**TINY["eva"], **(eva or {})}
    b = {**TINY["bert"], **(bert or {})}
    m = {**TINY["mico"], **mico}
    if "image_size" in (eva or {}):
        m["vision_resolution"] = e["image_size"]
    jcfg = jax_config.MiCoConfig(eva_override=jax_config.EvaVitConfig(**e),
                                 bert_override=jax_config.BertConfig(**b), **m)
    tcfg = torch_config.MiCoConfig(eva_override=torch_config.EvaVitConfig(**e),
                                   bert_override=torch_config.BertConfig(**b),
                                   **m)
    return jcfg, tcfg


def perturbed_params(jcfg, seed: int = 0, scale: float = 0.05) -> dict:
    """`init_mico` params with N(0, scale) added to every leaf."""
    params = jax.jit(jax_mico.init_mico, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + scale * rng.standard_normal(
            a.shape).astype(np.float32)), params)


def to_numpy(params: dict) -> dict:
    return jax.tree.map(np.asarray, params)


def port_model(params: dict, tcfg):
    return mico_from_jax(to_numpy(params), tcfg, device="cpu")


# added to [SEP]'s MLM bias in the decoder tests, so that some rows finish
# mid-decode (at the perturbed init no row ever emits [SEP])
SEP_BIAS = 1.8


def decoder_setup(seed: int = 0):
    """(JAX bert params, JAX BertConfig, the port's `Bert` holding the same
    weights, a (4, 9, 64) condition) for the generation tests."""
    jcfg, tcfg = configs()
    params = perturbed_params(jcfg, seed)
    head = params["bert"]["mlm_head"]
    head["decoder_b"] = head["decoder_b"].at[jax_config.BERT_SEP_ID].add(
        SEP_BIAS)
    model = port_model(params, tcfg).bert
    cond = (3.0 * np.random.default_rng(seed + 7).standard_normal(
        (4, 9, 64))).astype(np.float32)
    return params["bert"], jcfg.bert_config, model, cond


def question_batch(b: int = 4, lq: int = 7, seed: int = 3):
    """(ids, mask) (b, lq) int32 questions [CLS] ... [SEP] of varied
    lengths, zero-padded."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, lq), np.int32)
    mask = np.zeros((b, lq), np.int32)
    for i in range(b):
        n = lq - (i % 3)
        ids[i, 0] = jax_config.BERT_CLS_ID
        ids[i, 1:n - 1] = rng.integers(1000, 20000, n - 2)
        ids[i, n - 1] = jax_config.BERT_SEP_ID
        mask[i, :n] = 1
    return ids, mask


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, tol=MODEL_TOL) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


def no_launch(fn):
    """fn()'s result, checking that it launched no kernel (the CPU routes
    take the plain versions)."""
    from mico_tpu_torch.ops import flash_attention as tfa

    before = tfa.launch_counts()
    out = fn()
    assert tfa.launch_counts() == before
    return out


# ---------------------------------------------------------------------------
# released-layout checkpoints
# ---------------------------------------------------------------------------

# the reference state_dict's names of the BERT layer and EVA block leaves
_BERT_LINEARS = {
    "q": "attention.self.query", "k": "attention.self.key",
    "v": "attention.self.value", "attn_out": "attention.output.dense",
    "inter": "intermediate.dense", "out": "output.dense",
    "xq": "crossattention.self.query", "xk": "crossattention.self.key",
    "xv": "crossattention.self.value",
    "x_out": "crossattention.output.dense",
}
_BERT_LNS = {"attn_ln": "attention.output.LayerNorm",
             "out_ln": "output.LayerNorm",
             "x_ln": "crossattention.output.LayerNorm"}
_EVA = {"norm1_w": "norm1.weight", "norm1_b": "norm1.bias",
        "norm2_w": "norm2.weight", "norm2_b": "norm2.bias",
        "q_bias": "attn.q_bias", "v_bias": "attn.v_bias",
        "proj_b": "attn.proj.bias", "fc1_b": "mlp.fc1.bias",
        "fc2_b": "mlp.fc2.bias"}
_EVA_LINEARS = {"qkv_w": "attn.qkv.weight", "proj_w": "attn.proj.weight",
                "fc1_w": "mlp.fc1.weight", "fc2_w": "mlp.fc2.weight"}
# the three checkpoint entries that hold no weight (tests/test_checkpoints.py)
NON_WEIGHTS = {"multimodal_encoder.bert.embeddings.position_ids",
               "multimodal_encoder.cls.predictions.decoder.bias",
               "vision_encoder.logit_scale"}


def reference_state_dict(params: dict, legacy: bool = False) -> dict:
    """The released checkpoint's state_dict (numpy fp32, torch layouts:
    linears (out, in), a conv patch embed) holding the canonical JAX
    `params`, plus the three non-weights; the inverse of JAX's
    `mico_from_torch`. legacy: some keys under the names the legacy-key
    surgery maps (video → vision, evaclip_model / clip_model →
    vision_encoder)."""
    p = jax.tree.map(lambda a: np.array(a, np.float32), params)
    sd = {}
    v = p["vision_encoder"]
    pre = "vision_encoder.visual."
    k = v["patch_embed"]["kernel"]                       # (3·p·p, w)
    patch = int(round((k.shape[0] / 3) ** 0.5))
    sd[pre + "patch_embed.proj.weight"] = k.T.reshape(-1, 3, patch, patch)
    sd[pre + "patch_embed.proj.bias"] = v["patch_embed"]["bias"]
    for name in ("cls_token", "pos_embed"):
        sd[pre + name] = v[name]
    sd[pre + "norm.weight"], sd[pre + "norm.bias"] = v["norm_w"], v["norm_b"]
    sd[pre + "head.weight"] = v["head"]["kernel"].T
    sd[pre + "head.bias"] = v["head"]["bias"]
    for i in range(v["blocks"]["qkv_w"].shape[0]):
        for leaf, name in _EVA.items():
            sd[f"{pre}blocks.{i}.{name}"] = v["blocks"][leaf][i]
        for leaf, name in _EVA_LINEARS.items():
            sd[f"{pre}blocks.{i}.{name}"] = v["blocks"][leaf][i].T
    sd["vision_encoder.logit_scale"] = np.float32(4.6)

    b = p["bert"]
    pre = "multimodal_encoder."
    emb = pre + "bert.embeddings."
    for leaf, name in (("word", "word_embeddings.weight"),
                       ("position", "position_embeddings.weight"),
                       ("token_type", "token_type_embeddings.weight"),
                       ("ln_w", "LayerNorm.weight"),
                       ("ln_b", "LayerNorm.bias")):
        sd[emb + name] = b["embeddings"][leaf]
    sd[emb + "position_ids"] = np.arange(
        b["embeddings"]["position"].shape[0], dtype=np.int64)[None]
    for i in range(b["layers"]["q_w"].shape[0]):
        lay = f"{pre}bert.encoder.layer.{i}."
        for leaf, name in _BERT_LINEARS.items():
            sd[f"{lay}{name}.weight"] = b["layers"][f"{leaf}_w"][i].T
            sd[f"{lay}{name}.bias"] = b["layers"][f"{leaf}_b"][i]
        for leaf, name in _BERT_LNS.items():
            sd[f"{lay}{name}.weight"] = b["layers"][f"{leaf}_w"][i]
            sd[f"{lay}{name}.bias"] = b["layers"][f"{leaf}_b"][i]
    head = pre + "cls.predictions."
    m = b["mlm_head"]
    sd[head + "transform.dense.weight"] = m["dense_w"].T
    sd[head + "transform.dense.bias"] = m["dense_b"]
    sd[head + "transform.LayerNorm.weight"] = m["ln_w"]
    sd[head + "transform.LayerNorm.bias"] = m["ln_b"]
    sd[head + "decoder.weight"] = m["decoder_w"].T
    sd[head + "bias"] = sd[head + "decoder.bias"] = m["decoder_b"]

    sd["contra_temp"] = p["contra_temp"]
    ih = p["itm_head"]
    sd["itm_head.linear1.weight"], sd["itm_head.linear1.bias"] = (
        ih["fc1_w"].T, ih["fc1_b"])
    sd["itm_head.layernorm.weight"], sd["itm_head.layernorm.bias"] = (
        ih["ln_w"], ih["ln_b"])
    sd["itm_head.linear2.weight"], sd["itm_head.linear2.bias"] = (
        ih["fc2_w"].T, ih["fc2_b"])
    for m in ("vision", "audio", "depth", "subtitle"):
        t = p[f"hidden_trans_{m}"]
        name = f"hidden_trans_{m}_multimodal"
        sd[f"{name}.0.weight"], sd[f"{name}.0.bias"] = t["kernel"].T, t["bias"]
        sd[f"{name}.1.weight"], sd[f"{name}.1.bias"] = t["ln_w"], t["ln_b"]
        sd[f"{m}_type_embeddings"] = p[f"{m}_type_embeddings"]
        if m != "subtitle":
            sd[f"{m}_frame_embedding"] = p[f"{m}_frame_embedding"]
    for m in ("t", "s", "v", "a", "d"):
        sd[f"contra_head_{m}.linear.weight"] = p[f"contra_head_{m}"]["kernel"].T
    for m in ("va", "id", "vs", "vas"):
        sd[f"contra_head_{m}.weight"] = p[f"contra_head_{m}"]["kernel"].T
        sd[f"contra_head_{m}.bias"] = p[f"contra_head_{m}"]["bias"]
    sd = {k: np.array(a, order="C") for k, a in sd.items()}
    if legacy:
        def old(key):
            if key.startswith("vision_encoder.visual.blocks.0."):
                return key.replace("vision_encoder", "clip_model")
            if key.startswith("vision_encoder.visual."):
                return key.replace("vision_encoder", "evaclip_model")
            return key.replace("vision", "video")
        sd = {old(k): a for k, a in sd.items()}
    return sd


def torch_state_dict(sd: dict, dtype=torch.float32) -> dict:
    """The numpy state_dict as torch tensors (integer buffers kept)."""
    out = {}
    for k, a in sd.items():
        t = torch.from_numpy(np.array(a))
        out[k] = t.to(dtype) if t.is_floating_point() else t
    return out


def tiny_model_cfg(**over) -> dict:
    """The tiny config as a `log/hps.json` model_cfg (both packages' loaders
    lift the override dicts)."""
    return {"eva_override": dict(TINY["eva"]),
            "bert_override": dict(TINY["bert"]), **TINY["mico"],
            "max_vision_sample_num": 4, "max_audio_sample_num": 2,
            "max_depth_sample_num": 2, **over}


def write_hps(root, model_cfg: dict) -> None:
    import json
    import os

    os.makedirs(os.path.join(root, "log"), exist_ok=True)
    with open(os.path.join(root, "log", "hps.json"), "w") as f:
        json.dump({"model_cfg": model_cfg}, f)


def write_pnm(path, img: np.ndarray, comment: bool = False) -> None:
    """uint8 (H, W, 3) as binary PPM, or (H, W) as binary PGM."""
    h, w = img.shape[:2]
    magic = b"P6" if img.ndim == 3 else b"P5"
    note = b"# written by a test\n" if comment else b""
    with open(path, "wb") as f:
        f.write(magic + b"\n" + note + f"{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def write_wav(path, samples: np.ndarray, sr: int = 16000) -> None:
    """int16 (n,) or (n, channels) samples as PCM WAV."""
    import wave

    samples = np.asarray(samples, np.int16)
    ch = 1 if samples.ndim == 1 else samples.shape[1]
    with wave.open(str(path), "wb") as f:
        f.setnchannels(ch)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(samples.tobytes())


def chirp_wav(path, seconds: float, seed: int = 0, sr: int = 16000) -> None:
    """A chirp plus noise drawn from `seed`, 16-bit mono."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = 0.4 * np.sin(2 * np.pi * (200 + 300 * t) * t)
    x = x + 0.05 * rng.standard_normal(t.shape)
    write_wav(path, np.clip(x * 32767, -32768, 32767).astype(np.int16), sr)


def media_files(root, seed: int = 0, size=(40, 52), frames: int = 6,
                seconds: float = 1.2) -> dict:
    """{image, video (a directory of PPM frames), audio (WAV)} under root,
    drawn from `seed`."""
    import os

    rng = np.random.default_rng(seed)
    h, w = size
    image = os.path.join(root, "image.ppm")
    write_pnm(image, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    video = os.path.join(root, "frames")
    os.makedirs(video, exist_ok=True)
    for i in range(frames):
        write_pnm(os.path.join(video, f"{i:04d}.ppm"),
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    audio = os.path.join(root, "audio.wav")
    chirp_wav(audio, seconds, seed)
    return {"image": image, "video": video, "audio": audio}
