"""The port's optimizer (trainers/optimization.py) against the JAX
package's optax chain on the CPU: every schedule at every step, and the
trained tensors after 6 micro-steps of the same gradients with clipping
and accumulation over k in {1, 2, 4}, in fp32; the optimizer's state
through state_dict; the schedule read at the count of applied updates."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from explicit_alignment_for_vqa_tasks_tpu.trainers import (  # noqa: E402
    optimization as jopt,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.trainers import (  # noqa: E402
    optimization as topt,
)
from explicit_alignment_for_vqa_tasks_tpu_torch.utils.attr_dict import (  # noqa: E402
    AttrDict,
)

# optax computes the schedule in fp32 and the port in float64: within
# SCHEDULE_REL of lr. The updates are the same fp32 arithmetic but for the
# scalars' roundings and sums in other orders: each trained tensor within
# PARAM_REL of its largest element.
SCHEDULE_REL = 1e-6
PARAM_REL = 1e-6
TOTAL_STEPS, MICRO_STEPS = 12, 6
SCHEDULES = [("none", 0), ("none", 3), ("linear", 0), ("linear", 3),
             ("cosine", 0), ("cosine", 3)]


def config(scheduler="none", warmup=0, clipping=0.0, accumulate=1,
           lr=1e-2):
    return AttrDict(train=AttrDict(
        lr=lr, scheduler=scheduler, adam_epsilon=1e-8,
        additional=AttrDict(warmup_steps=warmup, gradient_clipping=clipping,
                            gradient_accumulation_steps=accumulate)))


@pytest.mark.parametrize("scheduler,warmup", SCHEDULES)
def test_schedule_matches_jax(scheduler, warmup):
    cfg = config(scheduler, warmup)
    want = jopt.make_schedule(cfg, TOTAL_STEPS)
    got = topt.make_schedule(cfg, TOTAL_STEPS)
    for step in range(TOTAL_STEPS + 2):
        w = float(want(jnp.asarray(step)) if callable(want) else want)
        assert abs(got(step) - w) <= SCHEDULE_REL * cfg.train.lr, step


def params_and_grads(seed=0):
    """A mapper-shaped tree and MICRO_STEPS gradient trees (fp32)."""
    rng = np.random.default_rng(seed)
    shapes = {"fc1": {"w": (6, 8), "b": (8,)}, "fc2": {"w": (8, 10),
                                                       "b": (10,)}}

    def tree(scale):
        return {n: {k: (rng.standard_normal(s) * scale).astype(np.float32)
                    for k, s in layer.items()}
                for n, layer in shapes.items()}

    return tree(0.1), [tree(0.3) for _ in range(MICRO_STEPS)]


def run_jax(cfg, params, grads):
    tx, _ = jopt.make_optimizer(cfg, TOTAL_STEPS)

    @jax.jit
    def step(g, state, p):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    for g in grads:
        p, state = step(jax.tree.map(jnp.asarray, g), state, p)
    return jax.tree.map(np.asarray, p)


def port_tree(params):
    return {n: {k: torch.tensor(v, requires_grad=True)
                for k, v in layer.items()} for n, layer in params.items()}


def run_port(cfg, tree, grads, optimizer=None):
    optimizer = optimizer or topt.make_optimizer(
        cfg, TOTAL_STEPS, topt.tree_leaves(tree))[0]
    applied = []
    for g in grads:
        for t, gv in zip(topt.tree_leaves(tree),
                         topt.tree_leaves(jax.tree.map(torch.tensor, g))):
            t.grad = gv
        applied.append(optimizer.step())
    return optimizer, applied


@pytest.mark.parametrize("accumulate", [1, 2, 4])
@pytest.mark.parametrize("scheduler,warmup,clipping", [
    ("none", 0, 0.0), ("linear", 2, 0.5), ("cosine", 1, 0.0),
    ("none", 3, 0.5)])
def test_mapper_after_six_steps_matches_optax(scheduler, warmup, clipping,
                                              accumulate):
    cfg = config(scheduler, warmup, clipping, accumulate)
    params, grads = params_and_grads()
    want = run_jax(cfg, params, grads)
    tree = port_tree(params)
    optimizer, applied = run_port(cfg, tree, grads)
    assert applied == [(i + 1) % accumulate == 0 for i in range(MICRO_STEPS)]
    assert optimizer.applied == MICRO_STEPS // accumulate
    for got, w in zip(topt.tree_leaves(tree), topt.tree_leaves(want)):
        err = np.abs(got.detach().numpy() - w).max()
        assert err <= PARAM_REL * np.abs(w).max(), err
    assert all(t.grad is None for t in topt.tree_leaves(tree))


def test_clipping_scales_to_the_global_norm():
    """The gradient AdamW receives: scaled to norm ``clipping`` when its
    global norm is larger, as optax.clip_by_global_norm does, else as
    it is."""
    tree = {"w": torch.zeros(4, requires_grad=True)}
    opt = topt.MultiStepAdamW(topt.tree_leaves(tree), lambda s: 0.0,
                              eps=1e-8, clipping=1.0)
    seen = []
    opt._adamw = lambda grads: seen.append(grads[0].clone())
    tree["w"].grad = torch.tensor([3.0, 4.0, 0.0, 0.0])
    assert opt.step()
    torch.testing.assert_close(seen[0], torch.tensor([0.6, 0.8, 0.0, 0.0]))
    tree["w"].grad = torch.tensor([0.3, 0.4, 0.0, 0.0])
    assert opt.step()
    torch.testing.assert_close(seen[1], torch.tensor([0.3, 0.4, 0.0, 0.0]))


def test_state_dict_resumes_the_same_run():
    """Three micro-steps, the state saved into a fresh optimizer over a copy
    of the tensors, three more: equal to six without the break (k = 2 and a
    half-accumulated gradient at the break)."""
    cfg = config("linear", 2, 0.5, accumulate=2)
    params, grads = params_and_grads(1)
    whole = port_tree(params)
    run_port(cfg, whole, grads)
    first = port_tree(params)
    optimizer, _ = run_port(cfg, first, grads[:3])
    state = optimizer.state_dict()
    assert state["mini_step"] == 1 and state["applied"] == 1
    second = {n: {k: t.detach().clone().requires_grad_()
                  for k, t in layer.items()} for n, layer in first.items()}
    resumed = topt.make_optimizer(cfg, TOTAL_STEPS,
                                  topt.tree_leaves(second))[0]
    resumed.load_state_dict(state)
    run_port(cfg, second, grads[3:], optimizer=resumed)
    for got, want in zip(topt.tree_leaves(second), topt.tree_leaves(whole)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_first_update_reads_the_schedule_at_zero():
    """With warmup the schedule is 0 at count 0, so the first applied
    update changes nothing (optax reads its count before incrementing it;
    a scheduler stepped one call early would not give 0 here)."""
    cfg = config("none", warmup=4)
    params, grads = params_and_grads(2)
    tree = port_tree(params)
    optimizer, _ = run_port(cfg, tree, grads[:1])
    for got, want in zip(topt.tree_leaves(tree), topt.tree_leaves(params)):
        np.testing.assert_array_equal(got.detach().numpy(), want)
    run_port(cfg, tree, grads[1:2], optimizer=optimizer)
    assert any(not np.array_equal(g.detach().numpy(), w) for g, w in zip(
        topt.tree_leaves(tree), topt.tree_leaves(params)))
