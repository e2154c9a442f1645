"""The port's data-parallel step at 2 gloo ranks on the CPU against JAX's
single-device `make_train_step` on the global batch (the step JAX's run
path takes: `task_losses(..., axis_name=None)` on the global batch, its
tests/test_training.py:118-136 and :280-321), at the tiny fp32 config with
dropout off and JAX's draws recorded and injected (each rank takes its
rows of them, `objectives.Draws.take`):

  - `ret%tva` (ITC over gathered features, ITM negatives drawn over the
    gathered rows with the condition gathered with gradient) and `cap%tv`
    with unequal valid-token counts on the two ranks (the MLM mean over
    the global batch's tokens), each as plain data parallelism and as
    ZeRO-1; `cap%tv` leaves the contrastive heads and the audio path
    alone, and their parameters update as JAX's dense zero gradients
    update them;
  - ZeRO-1 splits the AdamW moments: each rank holds about half.
JAX's own tolerances: losses rtol 2e-5, parameters rtol 2e-4 / atol 2e-5.
The ranks are spawned once and run every case, while JAX takes its steps.
Gradient accumulation is `tests/test_torch_data_parallel_accum.py`'s (a
file of its own keeps each under a minute).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from mico_tpu.train import objectives as jobj
from mico_tpu.train import optim as joptim
from mico_tpu.train import train_step as jtrain_step

from mico_tpu_torch.convert import params_from_jax

from torch_dist_common import dp_steps, run_ranks
from torch_port_common import configs, perturbed_params, to_numpy

WORLD = 2
B = 4                       # the global batch: 2 rows a rank
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
# Adam's eps is raised so that the update is not scale-free, the clip
# triggers, the large weight decay moves the parameters a task leaves
# alone, and warmup 0 gives the first update the full rate
OC = dict(learning_rate=1e-2, clip_lr=5e-3, new_lr=2e-2,
          new_params_name=("contra_head",), weight_decay=0.5, eps=1e-3,
          grad_norm=0.5, num_train_steps=4, warmup_ratio=0.0)
LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
# (case, task, zero1, gradient accumulation, reference)
CASES = [("ret_dp", "ret%tva", False, 1, "ret"),
         ("ret_zero1", "ret%tva", True, 1, "ret"),
         ("cap_dp", "cap%tv", False, 1, "cap"),
         ("cap_zero1", "cap%tv", True, 1, "cap")]


def _batch(rng, unequal: bool, cap_len: int = 12):
    """A global batch of B rows; `unequal`: rank 0's two captions hold 5
    and 7 tokens, rank 1's all 12, so the ranks' valid-token counts
    differ."""
    ids = rng.integers(200, 20000, (B, cap_len)).astype(np.int32)
    ids[:, 0] = 101
    mask = np.ones((B, cap_len), np.int32)
    lengths = (5, 7, cap_len, cap_len) if unequal else (cap_len, 9, cap_len,
                                                         10)
    for i, n in enumerate(lengths):
        mask[i, n:] = 0
        ids[i, n:] = 0
    return {
        "vision_pixels": rng.standard_normal(
            (B, 2, 3, 28, 28)).astype(np.float32),
        "audio_spectrograms": rng.standard_normal(
            (B, 2, 28, 28)).astype(np.float32),
        "caption_ids": ids, "caption_mask": mask,
    }


def _record(jcfg, params, task, batches, keys):
    """JAX's draws for each global batch at `params` under PRNGKey(key),
    recorded in a forward-only jitted call (the updates of a case change
    no parameter before its last call: one update, or one MultiSteps
    window). → the calls as the ranks take them."""
    masks, cats = [], []
    mp = pytest.MonkeyPatch()
    try:
        real_mask, real_cat = jobj.mask_tokens, jax.random.categorical
        mp.setattr(jobj, "mask_tokens",
                   lambda *a, **kw: masks.append(real_mask(*a, **kw))
                   or masks[-1])
        mp.setattr(jax.random, "categorical",
                   lambda *a, **kw: cats.append(real_cat(*a, **kw))
                   or cats[-1])
        record = jax.jit(lambda p, k, b: (
            jobj.task_losses(k, p, jcfg, b, task), masks, cats))
        calls = []
        for i, batch in zip(keys, batches):
            jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
            _, jmasks, jcats = record(params, jax.random.PRNGKey(i), jbatch)
            calls.append((
                batch,
                [tuple(np.asarray(x) for x in pair) for pair in jmasks],
                [(np.asarray(jcats[j]), np.asarray(jcats[j + 1]))
                 for j in range(0, len(jcats), 2)]))
    finally:
        mp.undo()
    return calls


def _jax_steps(jcfg, params, task, accum, batches):
    """JAX's single-device updates, one call a global batch. → (JAX's
    losses per call, JAX's params)."""
    jopt = joptim.build_optimizer(params, joptim.OptimConfig(**OC))
    if accum > 1:
        jopt = optax.MultiSteps(jopt, every_k_schedule=accum)
    jstep = jtrain_step.make_train_step(jcfg, jopt, task, donate=False)
    state, wants = jopt.init(params), []
    for i, batch in enumerate(batches):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        params, state, want = jstep(params, state, jbatch,
                                    jax.random.PRNGKey(i))
        wants.append({k: float(v) for k, v in want.items()})
    return wants, to_numpy(params)


def run_cases(tmp_path_factory, cases, refs):
    """refs: {name: (task, accumulation, [(global batch, key)])}. JAX's
    draws first, then the ranks run `cases` while JAX takes its steps. →
    (port config, {name: (calls, JAX losses, JAX params)}, the starting
    state_dict, {case: [each rank's result]})."""
    jcfg, tcfg = configs(bert=NO_DROPOUT)
    params = perturbed_params(jcfg, seed=3)
    calls = {}
    for task in {t for t, _, _ in refs.values()}:
        names = [n for n, r in refs.items() if r[0] == task]
        got = _record(jcfg, params, task,
                      [b for n in names for b, _ in refs[n][2]],
                      [k for n in names for _, k in refs[n][2]])
        for n in names:
            calls[n], got = got[:len(refs[n][2])], got[len(refs[n][2]):]
    start = to_numpy(params)
    work = [dict(task=task, zero1=zero1, accum=accum, params=start,
                 tcfg=tcfg, oc=OC, calls=calls[ref])
            for _, task, zero1, accum, ref in cases]
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, dp_steps, WORLD,
                            tmp_path_factory.mktemp("dp"), work)
        out = {n: (calls[n],) + _jax_steps(jcfg, params, task, accum,
                                           [b for b, _ in batches])
               for n, (task, accum, batches) in refs.items()}
        ranks = ranks.result()
    return tcfg, out, params_from_jax(start, tcfg), {
        name: [o[i] for o in ranks] for i, (name, *_) in enumerate(cases)}


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    rng = np.random.default_rng(7)
    return run_cases(tmp_path_factory, CASES, {
        "ret": ("ret%tva", 1, [(_batch(rng, False), 0)]),
        "cap": ("cap%tv", 1, [(_batch(rng, True), 0)])})


def check_losses(stepped, case, cases=CASES):
    _, refs, _, got = stepped
    wants = refs[next(c[4] for c in cases if c[0] == case)][1]
    for rank_out in got[case]:
        assert len(rank_out["losses"]) == len(wants)
        for g, w in zip(rank_out["losses"], wants):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], **LOSS_TOL,
                                           err_msg=f"{case} {k}")
            if "grad_norm" in g:            # the clip triggered
                assert g["grad_norm"] > OC["grad_norm"]


def check_params(stepped, case, cases=CASES):
    tcfg, refs, start, got = stepped
    ref = refs[next(c[4] for c in cases if c[0] == case)]
    want = {k: v.numpy() for k, v in params_from_jax(ref[2], tcfg).items()}
    for rank_out in got[case]:
        assert sorted(rank_out["params"]) == sorted(want)
        for name, p in rank_out["params"].items():
            np.testing.assert_allclose(p, want[name], **PARAM_TOL,
                                       err_msg=f"{case} {name}")
    moved = max(float(np.abs(want[k] - start[k].numpy()).max())
                for k in want)
    assert moved > 100 * PARAM_TOL["atol"]


def check_split(stepped, case, plain=None):
    *_, got = stepped
    outs = got[case]
    total = outs[0]["param_numel"]
    assert all(o["split"] > 0.5 * o["leaves"] for o in outs)
    for o in outs:
        assert o["moment_numel"] < 0.6 * total
    assert all(o["moment_numel"] == total for o in got.get(plain, []))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_losses_match_jax_global_batch(stepped, case):
    check_losses(stepped, case)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_params_match_jax_global_batch(stepped, case):
    check_params(stepped, case)


def test_unequal_token_counts_are_a_global_mean(stepped):
    """The cap%tv batch's ranks hold 12 and 24 valid caption tokens: the
    global mean is not the mean of the ranks' means, and the port's loss
    is JAX's global one (test_losses_match_jax_global_batch)."""
    _, refs, _, _ = stepped
    batch = refs["cap"][0][0][0]
    counts = batch["caption_mask"].reshape(WORLD, -1).sum(1)
    assert counts[0] != counts[1]


@pytest.mark.parametrize("case", ["ret_zero1", "cap_zero1"])
def test_zero1_splits_the_moments(stepped, case):
    check_split(stepped, case, plain=case.replace("zero1", "dp"))
