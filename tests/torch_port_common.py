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

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mico_tpu import config as jax_config
from mico_tpu.models import mico as jax_mico
from mico_tpu_torch import config as torch_config
from mico_tpu_torch.convert import mico_from_jax

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
