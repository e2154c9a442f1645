"""The port's evaluator (`mico_tpu_torch/evaluation/__init__.py`) against
the JAX package's `Evaluator` at the tiny config, on the same weights
(`params_from_jax` of `init_mico`, every leaf perturbed; [SEP]'s MLM bias
raised so captions end mid-decode) and the same batches (numpy, seeded):
retrieval metrics equal and the similarity matrices within 1e-4, the ITM
re-rank scores within 1e-4 in the same order (both directions), beam-1
and beam-2 caption tokens identical, QA answers and accuracy equal, and
the registry's logs equal. The port runs on the CPU in fp32 (the plain
versions of the kernels)."""

import json
import os

import numpy as np
import pytest
import torch

import mico_tpu.evaluation as jev
from mico_tpu import config as jax_config
from mico_tpu.text import BertWordPieceTokenizer as JaxTokenizer
import mico_tpu_torch.evaluation as tev
from mico_tpu_torch.text import BertWordPieceTokenizer

from mico_tpu_torch.convert import mico_from_jax
from torch_port_common import (SEP_BIAS, configs, no_launch, perturbed_params,
                               port_model, replace, to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_VOCAB = os.path.join(ROOT, "mico_tpu", "assets", "vocab.txt")
SIM_TOL = 1e-4
WORDS = "a man dog runs on the snowy day red ball two playing park".split()


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs(max_caption_len=8, beam_size=2, itm_rerank_num=4,
                         max_vision_sample_num=2, max_audio_sample_num=2)
    params = perturbed_params(jcfg, seed=0)
    head = params["bert"]["mlm_head"]
    head["decoder_b"] = head["decoder_b"].at[jax_config.BERT_SEP_ID].add(
        SEP_BIAS)
    model = port_model(params, tcfg)
    return jcfg, tcfg, params, model


def batches(seed: int = 0, n: int = 2, b: int = 3):
    """n batches of b items: 2 frames and 2 audio slices each, captions
    (one item in three with two), questions and answers."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        caps, ids = [], []
        for i in range(b):
            c = " ".join(rng.choice(WORDS, 5))
            caps.append([c, " ".join(rng.choice(WORDS, 4))] if i % 3 == 0
                        else c)
            ids.append(f"v{k}{i}")
        out.append({
            "ids": ids, "raw_captions": caps,
            "vision_pixels": rng.standard_normal(
                (b, 2, 3, 28, 28)).astype(np.float32),
            "audio_spectrograms": rng.standard_normal(
                (b, 2, 28, 28)).astype(np.float32),
            "raw_questions": [" ".join(rng.choice(WORDS, 4)) + "?"
                              for _ in range(b)],
            "raw_answers": [["two", "ball", "two"] if i % 2 else "red"
                            for i in range(b)],
            "question_ids_raw": [100 * k + i for i in range(b)],
        })
    return out


def evaluators(setup, **cfg_over):
    jcfg, tcfg, params, model = setup
    jcfg, tcfg = replace(jcfg, **cfg_over), replace(tcfg, **cfg_over)
    return (jev.Evaluator(jcfg, params, JaxTokenizer(JAX_VOCAB)),
            tev.Evaluator(tcfg, model, BertWordPieceTokenizer()))


def spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("task", ["ret%tv", "ret%tva"])
def test_retrieval_matches_jax(setup, monkeypatch, task, bidirectional):
    jeval, teval = evaluators(setup,
                              ret_bidirection_evaluation=bidirectional)
    jcalls = spy(monkeypatch, jev, "retrieval_recall")
    tcalls = spy(monkeypatch, tev, "retrieval_recall")
    data = batches()
    want = jeval.eval_retrieval(data, task, itm_rerank=True)
    got = no_launch(lambda: teval.eval_retrieval(data, task,
                                                 itm_rerank=True))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    assert len(tcalls) == len(jcalls) == 2          # ITC, then the re-rank
    for (ta, _, _), (ja, _, _) in zip(tcalls, jcalls):
        assert list(ta[1]) == list(ja[1])            # text → item map
        assert ta[0].shape == (8, 6)                 # 8 captions, 6 items
        np.testing.assert_allclose(ta[0], ja[0], rtol=0, atol=SIM_TOL)
    rerank_t, rerank_j = tcalls[1][0][0], jcalls[1][0][0]
    np.testing.assert_array_equal(np.argsort(-rerank_t, axis=1, kind="stable"),
                                  np.argsort(-rerank_j, axis=1, kind="stable"))
    # every text re-scored its top 4 items, the rest keep the floor
    assert ((rerank_t > -1.0).sum(axis=1) >= 4).all()


@pytest.mark.parametrize("beams", [1, 2])
@pytest.mark.parametrize("task", ["cap%tv", "cap%ta"])
def test_caption_tokens_match_jax(setup, monkeypatch, beams, task):
    jeval, teval = evaluators(setup, beam_size=beams)
    jcalls = spy(monkeypatch, jev, "generate")
    tcalls = spy(monkeypatch, tev, "generate")
    data = batches(1)
    want = jeval.eval_caption(data, task)
    got = no_launch(lambda: teval.eval_caption(data, task))
    assert len(tcalls) == len(jcalls) == 2
    for (_, tkw, tout), (_, jkw, jout) in zip(tcalls, jcalls):
        assert tkw["num_beams"] == jkw["num_beams"] == beams
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    ended = [(np.asarray(j) == jax_config.BERT_SEP_ID).any(axis=1)
             for _, _, j in jcalls]
    assert np.concatenate(ended).any()            # some rows end mid-decode
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k


def test_qa_matches_jax(setup, monkeypatch, tmp_path):
    jeval, teval = evaluators(setup)
    jcalls = spy(monkeypatch, jev, "generate_answers")
    tcalls = spy(monkeypatch, tev, "generate_answers")
    data = batches(2)
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    want = jeval.eval_qa(data, "qa%tv", submission_path=jpath)
    got = no_launch(lambda: teval.eval_qa(data, "qa%tv",
                                          submission_path=tpath))
    for (_, _, tout), (_, _, jout) in zip(tcalls, jcalls):
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert got == pytest.approx(want, abs=1e-12)
    with open(tpath) as f, open(jpath) as g:
        assert json.load(f) == json.load(g)
    assert got["num_submitted"] == 6.0


def test_registry_logs_match_jax(setup, tmp_path):
    """evaluation_mm over a retrieval, a caption and a QA loader."""
    jeval, teval = evaluators(setup)
    loaders = {"ret%tva--a": batches(3), "cap%tv--b": batches(4),
               "qa%tv--c": batches(5)}
    run_cfg = {"itm_rerank": True, "output_dir": str(tmp_path)}
    want = jev.evaluation_mm(jeval, loaders, run_cfg, 3)
    got = tev.evaluation_mm(teval, loaders, run_cfg, 3)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == pytest.approx(want[name], abs=1e-12), name


def test_captioner_mode_annotates(setup, tmp_path):
    """captioner_mode: generate_nums top-k samples per clip, written as
    annotations (the draws are torch's, so the samples are not JAX's)."""
    _, teval = evaluators(setup)
    teval.run_cfg = {"top_k": 5}
    path = str(tmp_path / "ann.json")
    out = teval.eval_caption(batches(6), "cap%tv", captioner_mode=True,
                             generate_nums=3, output_path=path)
    assert out == {"num_annotated": 6.0}
    with open(path) as f:
        ann = json.load(f)
    assert len(ann) == 6 and all(len(a["tv_captions"]) == 3 for a in ann)


def test_evaluator_uses_the_model_compute_dtype(setup, monkeypatch):
    """A bf16 config's eval passes run in bf16: the condition tokens the
    ViT gives ITM come out in the model's compute dtype."""
    _, tcfg, params, _ = setup
    bf = replace(tcfg, compute_dtype="bfloat16")
    model = mico_from_jax(to_numpy(params), bf, device="cpu")
    teval = tev.Evaluator(bf, model, BertWordPieceTokenizer())
    calls = spy(monkeypatch, tev, "compute_features")
    out = teval.eval_retrieval(batches(7, n=1), "ret%tv", itm_rerank=True)
    assert calls and all(o["condition_feats_v"].dtype == torch.bfloat16
                         for _, _, o in calls)
    assert 0.0 <= out["video_r1"] <= 1.0
