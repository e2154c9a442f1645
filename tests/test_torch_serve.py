"""The port's serving pipeline (`mico_tpu_torch/serve.py`) against
`mico_tpu.serve.EmbeddingPipeline` on the CPU: text embeddings through the
tokenizer, and `_run`'s fixed-size padded batches with failed items as zero
rows, fed decoded arrays. The media entry points against JAX's on files are
in `tests/test_torch_media.py`."""

from pathlib import Path

import numpy as np
import pytest

from mico_tpu.serve import EmbeddingPipeline as JaxPipeline
from mico_tpu.text import BertWordPieceTokenizer as JaxTokenizer
from mico_tpu_torch.serve import EmbeddingPipeline
from mico_tpu_torch.text import BertWordPieceTokenizer

from torch_port_common import MODEL_TOL, close, configs, perturbed_params, \
    port_model

JAX_VOCAB = (Path(__file__).resolve().parent.parent / "mico_tpu" / "assets"
             / "vocab.txt")
TEXTS = ["a dog barks", "music plays loudly in the hall", "silence",
         "two cats, one hat!"]


@pytest.fixture(scope="module")
def pipes():
    jcfg, tcfg = configs()
    params = perturbed_params(jcfg)
    jpipe = JaxPipeline(params, jcfg, JaxTokenizer(JAX_VOCAB), batch_size=3,
                        io_workers=2, melbins=28, target_length=28,
                        resize_melbin_num=28)
    model = port_model(params, tcfg)
    tpipe = EmbeddingPipeline(model, tcfg, BertWordPieceTokenizer(),
                              batch_size=3, io_workers=2, device="cpu")
    yield jpipe, tpipe, model
    tpipe.close()


def test_embed_texts(pipes):
    jpipe, tpipe, _ = pipes
    want = jpipe.embed_texts(TEXTS)
    got = tpipe.embed_texts(TEXTS)
    assert got.shape == (4, 32)
    close(got, want, MODEL_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    sims = tpipe.similarity(got, got)
    close(sims, jpipe.similarity(want, want), MODEL_TOL)


def test_run_pads_and_reports_failures(pipes, rng):
    """7 items in batches of 3 (the last padded), items 1 and 5 failed:
    zero rows at their indices, unit rows elsewhere, as JAX's `_run`."""
    jpipe, tpipe, _ = pipes
    items = [rng.standard_normal((1, 3, 28, 28)).astype(np.float32)
             for _ in range(7)]
    items[1] = items[5] = None
    seen = []

    def device_fn(model, x):
        seen.append(tuple(x.shape))
        return tpipe._embed_pixels(model, x, head="v")

    got = tpipe._run(items, lambda a: a, device_fn)
    want = jpipe._run(items, lambda a: a,
                      lambda p, x: jpipe._embed_pixels(p, x, head="v"))
    assert seen == [(3, 1, 3, 28, 28)] * 3
    assert tpipe.last_failures == jpipe.last_failures == [1, 5]
    assert got.shape == (7, 32)
    np.testing.assert_array_equal(got[[1, 5]], 0.0)
    np.testing.assert_allclose(
        np.linalg.norm(np.delete(got, [1, 5], axis=0), axis=-1), 1.0,
        rtol=1e-5)
    close(got, want, MODEL_TOL)


def test_run_all_failed_chunk(pipes, rng):
    """A leading batch with no decodable item yields zero rows and the
    shape is taken from a later batch."""
    _, tpipe, _ = pipes
    items = [None, None, None,
             rng.standard_normal((1, 3, 28, 28)).astype(np.float32)]
    got = tpipe._run(items, lambda a: a,
                     lambda m, x: tpipe._embed_pixels(m, x, head="v"))
    assert tpipe.last_failures == [0, 1, 2]
    np.testing.assert_array_equal(got[:3], 0.0)
    assert abs(np.linalg.norm(got[3]) - 1.0) < 1e-5


def test_folds_a_copy(pipes):
    """fold_constants (default) serves a folded copy; the caller's model
    keeps its LN affines."""
    _, tpipe, model = pipes
    assert model.vision_encoder.blocks[0].get("norm1_w") is not None
    assert tpipe.model.vision_encoder.blocks[0].get("norm1_w") is None


def test_postnorm_pipeline_serves_a_folded_copy(rng):
    """A post-norm tower with LayerScale (the EVA02-CLIP-bigE block): the
    pipeline folds only LayerScale into its copy, keeps the LNs, and `_run`
    gives JAX's folded pipeline's embeddings."""
    jcfg, tcfg = configs(eva=dict(postnorm=True, ls_init_value=0.1))
    params = perturbed_params(jcfg, seed=2)
    jpipe = JaxPipeline(params, jcfg, batch_size=2, io_workers=2)
    model = port_model(params, tcfg)
    tpipe = EmbeddingPipeline(model, tcfg, batch_size=2, io_workers=2,
                              device="cpu")
    try:
        blk = tpipe.model.vision_encoder.blocks[0]
        assert blk.get("gamma_1") is None and blk.get("norm1_w") is not None
        assert model.vision_encoder.blocks[0].get("gamma_1") is not None
        items = [rng.standard_normal((1, 3, 28, 28)).astype(np.float32)
                 for _ in range(3)]
        got = tpipe._run(items, lambda a: a,
                         lambda m, x: tpipe._embed_pixels(m, x, head="v"))
    finally:
        tpipe.close()
    want = jpipe._run(items, lambda a: a,
                      lambda p, x: jpipe._embed_pixels(p, x, head="v"))
    close(got, want, MODEL_TOL)


@pytest.mark.parametrize("method", ["embed_images", "embed_videos",
                                    "embed_depth", "embed_audio"])
def test_media_entry_points_raise(pipes, method, tmp_path, capsys,
                                  monkeypatch):
    """An item whose decoder raises (an audio container that needs libav,
    a file no reader takes) is caught by its processor, which prints the
    reason, and comes back as a zero row in `last_failures`. Audio: MP3,
    Ogg and junk raise naming what was found; a FLAC beside them decodes."""
    from mico_tpu_torch.media.processors import AudioProcessor
    from torch_flac_writer import write_flac

    _, tpipe, _ = pipes
    if method == "embed_audio":
        # the tiny tower's geometry, as the JAX pipe of the fixture has it
        monkeypatch.setattr(tpipe, "audio_proc", AudioProcessor(
            melbins=28, target_length=28, resize_melbin_num=28,
            sample_num=tpipe.cfg.max_audio_sample_num, training=False))
        paths = []
        for name, head in (("x.mp3", b"ID3\x04" + bytes(60)),
                           ("x.ogg", b"OggS\x00\x02" + bytes(60)),
                           ("x.flac", b"\x00 not media")):
            (tmp_path / name).write_bytes(head)
            paths.append(str(tmp_path / name))
        pcm = np.random.default_rng(1).integers(-9000, 9000, (40000, 2))
        write_flac(tmp_path / "ok.flac", pcm, 44100, 16)
        got = tpipe.embed_audio(paths + [str(tmp_path / "ok.flac")])
        assert tpipe.last_failures == [0, 1, 2]
        assert got.shape == (4, 32) and not got[:3].any() and got[3].any()
        said = capsys.readouterr().out
        for what in ("MP3", "Ogg", "unknown container", "libav codecs"):
            assert what in said
        return
    name = {"embed_videos": "x.mp4"}.get(method, "x.jpg")
    bad = tmp_path / name
    bad.write_bytes(b"\x00 not media")
    got = getattr(tpipe, method)([str(bad)])
    assert tpipe.last_failures == [0]
    assert got.shape == (1, 32) and not got.any()
    said = capsys.readouterr().out
    assert {"embed_videos": "cannot open video"}.get(
        method, "cannot decode image") in said