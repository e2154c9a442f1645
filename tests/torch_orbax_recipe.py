"""The values of the committed `.orbax` fixtures (`tests/fixtures/orbax/`),
rebuilt with numpy alone: `scripts/make_orbax_fixtures.py` saves them
through the JAX package, and the CPU tests and `chip_smoke.py` (which loads
this file by path) hold what the port reads to them bit for bit.

A leaf is (keys, zarr dtype, array): keys as orbax's key path (a str is a
dict key, an int a list index), a bfloat16 leaf as its uint16 bits (numpy
has no bfloat16; `bf16_bits` rounds as JAX's `astype` does).
"""

from __future__ import annotations

import numpy as np

SEED = 23
MODEL_STEP = 3      # model_step_3.orbax / optimizer_step_3.orbax
SHARDED = ("sharded",)


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """fp32 → the bits of bfloat16, rounded to nearest even (finite x)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def model_leaves(kind: str) -> list:
    """The model tree of fixture `kind`: "single" (one process; fp32 and
    bf16 leaves that zstd codes with Huffman literals and FSE sequences,
    values past the inline limit, an int32 scalar, a list of two block
    dicts, a leaf sharded over 4 devices) or "multi" (the small tree two
    processes save, its sharded leaf over one device of each)."""
    rng = np.random.default_rng(SEED if kind == "single" else SEED + 1)
    f32 = np.float32
    if kind == "single":
        return [
            (("dense", "w"), "<f4",
             rng.standard_normal((48, 96)).astype(f32)),
            (("dense", "q"), "<f4",
             rng.integers(-8, 8, (64, 64)).astype(f32) * f32(0.5)),
            (("dense", "b"), "bfloat16",
             bf16_bits(rng.standard_normal((32, 64)).astype(f32))),
            (("step",), "<i4", np.array(7, np.int32)),
            (("blocks", 0, "x"), "<f4",
             rng.standard_normal((8, 16)).astype(f32)),
            (("blocks", 1, "x"), "<f4",
             rng.standard_normal((16,)).astype(f32)),
            (SHARDED, "<f4", rng.standard_normal((16, 32)).astype(f32)),
        ]
    return [
        (("dense", "w"), "<f4", rng.standard_normal((16, 32)).astype(f32)),
        (("dense", "b"), "bfloat16",
         bf16_bits(rng.standard_normal((8, 16)).astype(f32))),
        (("step",), "<i4", np.array(5, np.int32)),
        (SHARDED, "<f4", rng.standard_normal((8, 16)).astype(f32)),
    ]


def optimizer_leaves(kind: str) -> list:
    """The optimizer file of fixture `kind`: JAX's positional layout
    ({"0": count, "1": μ, "2": ν} of the dense weight)."""
    rng = np.random.default_rng(SEED + 10 + (kind != "single"))
    shape = (48, 96) if kind == "single" else (16, 32)
    mu = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    nu = (rng.standard_normal(shape) ** 2 * 1e-4).astype(np.float32)
    return [(("0",), "<i4", np.array(MODEL_STEP, np.int32)),
            (("1",), "<f4", mu), (("2",), "<f4", nu)]
