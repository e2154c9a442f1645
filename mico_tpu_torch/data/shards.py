"""Tar-shard streaming dataset (counterpart of `mico_tpu/data/shards.py`),
with no dependency beyond the standard library's `tarfile`.

The reference `SrcIndexedDataset` (data/data/IndexSrc.py:30-188), which
wraps `webdataset`:
  - a shard list from a directory of .tar, a single .tar, or a JSON list;
  - resampled shard order (infinite re-draw of shards) and a 1000-sample
    shuffle buffer;
  - samples grouped by tar-member key; fields selected by suffix
    ("mp4"/"jpg" [+ "txt"]); a per-sample error is printed and the sample
    skipped (`warn_and_continue`, IndexSrc.py:140-145);
  - `process`: image decode (video containers need the decoders that are
    not ported), the vision transforms, captions from json/dir txt stores.
"""

from __future__ import annotations

import json
import os
import random
import tarfile
import tempfile
from typing import Iterator, List, Optional

import numpy as np

from mico_tpu_torch.data.mappers import VisionMapper

_FIELDS = ("vision_pixels", "raw_captions", "ids")


def _shard_list(vision: str) -> List[str]:
    if vision.endswith("json"):
        with open(vision) as f:
            return list(json.load(f))
    if vision.endswith("tar"):
        return [vision]
    return sorted(os.path.join(vision, i) for i in os.listdir(vision)
                  if i.endswith(".tar"))


def iter_tar_samples(path: str) -> Iterator[dict]:
    """Yield {suffix: bytes, '__key__': str} dicts, grouping consecutive tar
    members that share a basename-without-suffix (webdataset convention)."""
    with tarfile.open(path, "r|*") as tf:
        current_key, sample = None, {}
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            key, _, suffix = name.rpartition(".")
            if key == "":
                key, suffix = name, ""
            if key != current_key:
                if current_key is not None and sample:
                    sample["__key__"] = current_key
                    yield sample
                current_key, sample = key, {}
            f = tf.extractfile(member)
            if f is not None:
                sample[suffix] = f.read()
        if current_key is not None and sample:
            sample["__key__"] = current_key
            yield sample


class ShardSampleProcessor:
    """Decode and transform one tar sample (reference ArgClass.process,
    IndexSrc.py:85-137)."""

    def __init__(self, d_cfg: dict, model_cfg: dict,
                 seed: Optional[int] = None):
        self.vision_format = d_cfg["vision_format"]
        self.txt_format = d_cfg.get("txt_format")
        self._mapper = VisionMapper(
            {**d_cfg, "vision": "",
             "vision_sample_num": d_cfg.get("vision_sample_num", 1)},
            model_cfg, seed)
        self._rng = random.Random(seed)
        if self.txt_format == "json":
            with open(d_cfg["txt"]) as f:
                self.txt = json.load(f)
        else:
            self.txt = d_cfg.get("txt")

    def _caption_for(self, id_: str):
        if self.txt_format == "json":
            return self.txt[id_]
        if self.txt_format == "dir":
            p = os.path.join(self.txt, id_[:5] + ".json")
            if os.path.exists(p):
                with open(p) as f:
                    files = json.load(f)
                for k in (id_[:5] + "/" + id_, id_):
                    if k in files:
                        return self._rng.choice(files[k])
        return None

    def __call__(self, item: dict):
        key = item["__key__"]
        id_ = key.split("/")[1] if "/" in key else key
        raw_captions = item.get("txt")
        if isinstance(raw_captions, bytes):
            raw_captions = raw_captions.decode()

        if self.vision_format.startswith("image"):
            import cv2

            arr = cv2.imdecode(np.frombuffer(item["jpg"], np.uint8),
                               cv2.IMREAD_COLOR)
            if arr is None:
                raise ValueError(f"bad image {key}")
            chw = arr[:, :, ::-1].transpose(2, 0, 1)  # BGR→RGB
            pixels = self._mapper._transform(
                chw[None].astype(np.float32) / 255.0)
        elif self.vision_format.startswith("video"):
            # container decoders need a seekable file; spill tar bytes to tmp
            with tempfile.NamedTemporaryFile(suffix=".mp4") as tmp:
                tmp.write(item["mp4"])
                tmp.flush()
                pixels = self._mapper._read_rawvideo_path(tmp.name)
        else:
            raise NotImplementedError(self.vision_format)

        cap = self._caption_for(id_)
        if cap is not None:
            raw_captions = cap
        if raw_captions is None:
            raise ValueError(f"no caption for {key}")
        return pixels, raw_captions, id_


class ShardIndexedDataset:
    """Infinite iterable over tar shards. `use_sampler = False`: each
    process or worker takes its own shard draw order (a seed offset)."""

    use_sampler = False

    def __init__(self, d_cfg: dict, model_cfg: dict,
                 seed: Optional[int] = None):
        self.shards = _shard_list(d_cfg["vision"])
        if not self.shards:
            raise ValueError(f"no shards under {d_cfg['vision']}")
        self.process = ShardSampleProcessor(d_cfg, model_cfg, seed)
        self.shuffle_buffer = int(d_cfg.get("shuffle_buffer", 1000))
        self.seed = seed
        self.collate_fn = shard_collate

    def _raw_iter(self, rng: random.Random) -> Iterator[dict]:
        while True:  # resampled=True → infinite shard redraws
            order = list(self.shards)
            rng.shuffle(order)
            for shard in order:
                try:
                    yield from iter_tar_samples(shard)
                except Exception as e:  # noqa: BLE001 — bad shard: go on
                    print(e)

    def __iter__(self):
        rng = random.Random(self.seed)
        buf: List = []
        for item in self._raw_iter(rng):
            try:
                sample = self.process(item)
            except NotImplementedError:
                raise
            except Exception as e:  # noqa: BLE001 — warn_and_continue
                print(e)
                continue
            buf.append(sample)
            if len(buf) >= self.shuffle_buffer:
                i = rng.randrange(len(buf))
                buf[i], sample = sample, buf[i]
                yield sample
        rng.shuffle(buf)
        yield from buf


def shard_collate(samples) -> dict:
    batch = {}
    for key, column in zip(_FIELDS, zip(*samples)):
        if column[0] is None:
            continue
        if isinstance(column[0], np.ndarray):
            batch[key] = np.stack(column).astype(np.float32)
        else:
            batch[key] = list(column)
    return batch
