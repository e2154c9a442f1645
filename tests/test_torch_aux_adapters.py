"""The port's stand-alone adapters against the JAX package's on the CPU:
the HF poolers and `pool_and_project` (fp32, `OP_TOL`), `HFTokenizer` on a
local tokenizer directory written here from the port's WordPiece vocab
(ids compared exactly; no hub name is ever asked for), `TimmBackbone` on a
stub `timm` module (the projection bit for bit, the output within
`OP_TOL`) and its ImportError without one, and the pretrained registry."""

import json
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.models import timm_adapter as jtimm
from mico_tpu.text import hf_adapter as jhf
from mico_tpu.utils import pretrained as jpre
from mico_tpu_torch.models import timm_adapter as ttimm
from mico_tpu_torch.text import hf_adapter as thf
from mico_tpu_torch.text.wordpiece import DEFAULT_VOCAB
from mico_tpu_torch.utils import pretrained as tpre

from torch_port_common import OP_TOL, close, t


@pytest.mark.parametrize("pooler", sorted(jhf.POOLERS))
@pytest.mark.parametrize("project", [False, True], ids=["pool", "project"])
def test_poolers_match_jax(pooler, project):
    rng = np.random.default_rng(1)
    h = rng.standard_normal((3, 5, 8)).astype(np.float32)
    m = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]],
                 np.int32)
    proj = rng.standard_normal((8, 4)).astype(np.float32) if project else None
    want = jhf.pool_and_project(jnp.asarray(h), jnp.asarray(m), pooler,
                                None if proj is None else jnp.asarray(proj))
    got = thf.pool_and_project(t(h), t(m), pooler,
                               None if proj is None else t(proj))
    assert got.shape == ((3, 4) if project else (3, 8))
    close(got, want, OP_TOL)


def test_pooler_registry():
    assert sorted(thf.POOLERS) == sorted(jhf.POOLERS)
    assert thf.ARCH_POOLERS == jhf.ARCH_POOLERS
    for arch in ("roberta", "bert", "mt5", "unknown-model"):
        assert thf.default_pooler_for(arch) == jhf.default_pooler_for(arch)

    @thf.register_pooler("last_pooler")
    def last(hidden, attention_mask):
        return hidden[:, -1]

    try:
        h = torch.arange(12.0).reshape(1, 3, 4)
        assert thf.pool_and_project(h, None, "last_pooler").tolist() == \
            [[8.0, 9.0, 10.0, 11.0]]
    finally:
        del thf.POOLERS["last_pooler"]
    # the masked max never takes a padded token, whatever its value
    h = torch.tensor([[[1.0], [5.0]]], dtype=torch.bfloat16)
    assert thf.max_pooler(h, torch.tensor([[1, 0]])).item() == 1.0


def test_hf_tokenizer_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    (tmp_path / "vocab.txt").write_bytes(open(DEFAULT_VOCAB, "rb").read())
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True,
         "model_max_length": 512}))
    texts = ["a photo of  a cat", "The QUICK brown\tfox; jumped!",
             "word " * 40, ""]
    jtok, ttok = jhf.HFTokenizer(str(tmp_path)), thf.HFTokenizer(str(tmp_path))
    want = jtok(texts, context_length=16)
    got = ttok(texts, context_length=16)
    assert got.dtype == np.int32 and got.shape == (4, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ttok("a cat", 8), jtok("a cat", 8))


class _Trunk(torch.nn.Module):
    """A conv and a global average pool, its weights from a fixed seed."""

    num_features = 6

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(3)
        self.conv = torch.nn.Conv2d(3, 6, 3)
        with torch.no_grad():
            for p in self.conv.parameters():
                p.copy_(torch.randn(p.shape, generator=g))

    def forward(self, x):
        return self.conv(x).mean(dim=(2, 3))


def stub_timm():
    calls = []

    def create_model(name, pretrained, num_classes, global_pool):
        calls.append((name, pretrained, num_classes, global_pool))
        return _Trunk()

    return types.SimpleNamespace(create_model=create_model), calls


@pytest.mark.parametrize("proj", ["linear", "none"])
def test_timm_backbone_matches_jax(monkeypatch, proj):
    stub, calls = stub_timm()
    monkeypatch.setitem(sys.modules, "timm", stub)
    jb = jtimm.TimmBackbone("resnet18", embed_dim=5, proj=proj, seed=7)
    tb = ttimm.TimmBackbone("resnet18", embed_dim=5, proj=proj, seed=7,
                            device="cpu")
    assert calls == [("resnet18", False, 0, "avg")] * 2
    if proj == "linear":
        np.testing.assert_array_equal(tb.proj.numpy(), jb.proj)
    else:
        assert tb.proj is None and jb.proj is None
    x = np.random.default_rng(2).standard_normal((2, 3, 9, 9)).astype(
        np.float32)
    got = tb(x)
    assert isinstance(got, torch.Tensor) and not tb.trunk.training
    close(got, jb(x), OP_TOL)
    with pytest.raises(NotImplementedError):
        ttimm.TimmBackbone("resnet18", 5, proj="mlp", device="cpu")


def test_timm_gated(monkeypatch):
    monkeypatch.setitem(sys.modules, "timm", None)
    with pytest.raises(ImportError) as jerr:
        jtimm.TimmBackbone("resnet18", 5)
    with pytest.raises(ImportError) as terr:
        ttimm.TimmBackbone("resnet18", 5, device="cpu")
    assert str(terr.value) == str(jerr.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttimm.TimmBackbone("resnet18", 5)


def test_pretrained_registry(tmp_path, monkeypatch):
    assert tpre.PRETRAINED == jpre.PRETRAINED
    assert tpre.list_pretrained() == jpre.list_pretrained()
    assert "EVA01-CLIP-g-14/laion400m" in tpre.list_pretrained()
    assert tpre.get_pretrained_url("BEATs", "iter3-plus-AS2M").startswith(
        "http")
    assert tpre.get_pretrained_cfg("nope", "x") == {}
    monkeypatch.setenv("MICO_CACHE", str(tmp_path))
    assert tpre.cache_dir() == jpre.cache_dir() == str(tmp_path)
    monkeypatch.delenv("MICO_CACHE")
    assert tpre.cache_dir() == jpre.cache_dir()
    with pytest.raises(KeyError):
        tpre.resolve_pretrained("nope", "x")
    with pytest.raises(FileNotFoundError, match="huggingface"):
        tpre.resolve_pretrained("MiCo-ViT-g-14", "omnimodal-300k-b64k",
                                cache=str(tmp_path))
    f = tmp_path / "BEATs_iter3_plus_AS2M.pt"
    f.write_bytes(b"fake")
    assert tpre.resolve_pretrained(
        "BEATs", "iter3-plus-AS2M", cache=str(tmp_path)) == str(f)
    digest = tpre.sha256_file(str(f))
    assert digest == jpre.sha256_file(str(f))
    assert tpre.verify_checkpoint(str(f), digest[:12].upper())
    assert tpre.verify_checkpoint(str(f), "")
    assert not tpre.verify_checkpoint(str(f), "deadbeef")
    monkeypatch.setitem(tpre.PRETRAINED["BEATs"]["iter3-plus-AS2M"],
                        "sha256", "deadbeef")
    with pytest.raises(ValueError, match="sha256"):
        tpre.resolve_pretrained("BEATs", "iter3-plus-AS2M",
                                cache=str(tmp_path))
