"""Field augmentations in the port == dgn_tpu's, from each field function to
one augmented Adam step.

RNG streams cannot match across frameworks, so every comparison draws the
uniforms with JAX, as dgn_tpu's own code draws them, and hands the same
draws to the port (ops/field.py takes draws in place of keys;
Trainer.train_step takes them as `aug`).

The train step runs flip, augmentation 15 and distortion 0.1 (the values of
tests/test_train.py) on a small ZINC net that carries every option of this
slice: towers (2, divide_input off then on), posttrans_layers 2, the
virtual node and a positional encoding from the loaded eig (hidden 10,
L=2), on one batch of 12 graphs and on the same graphs in 2 micro-batches,
against dgn_tpu's Trainer._train_step.  Dropout is 0.

Tolerances: field functions rtol 1e-6 / atol 1e-6 (f32, the rotation's
sin from two libms); the step's loss and scores rtol 1e-5 / atol 1e-6, the
parameters after one Adam step and the BN running stats rtol 1e-4 /
atol 1e-5, as tests/test_torch_model.py holds them.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgn_tpu.data import synthetic as jsyn
from dgn_tpu.data.loader import BatchLoader as JBatchLoader
from dgn_tpu.models import DGNConfig as JConfig
from dgn_tpu.models import zinc_model as jzinc
from dgn_tpu.ops import field as jfield
from dgn_tpu.ops.scalers import degree_stats
from dgn_tpu.train.trainer import TrainParams as JParams
from dgn_tpu.train.trainer import Trainer as JTrainer
from dgn_tpu.train.trainer import TrainState

from dgn_tpu_torch import graph as tgraph
from dgn_tpu_torch.convert import flatten, flax_path, load_jax_params
from dgn_tpu_torch.data.loader import BatchLoader as TBatchLoader
from dgn_tpu_torch.models import DGNConfig as TConfig
from dgn_tpu_torch.models import zinc_model as tzinc
from dgn_tpu_torch.ops import aggregators as agg_ops
from dgn_tpu_torch.ops import field as tfield
from dgn_tpu_torch.train.trainer import AugDraws
from dgn_tpu_torch.train.trainer import TrainParams as TParams
from dgn_tpu_torch.train.trainer import Trainer as TTrainer
from test_torch_layers import run_jitted

torch.set_num_threads(1)

LR, P = 1e-3, 3
AUG = dict(flip=True, augmentation=15.0, distortion=0.1)
FIELD = dict(rtol=1e-6, atol=1e-6)
STEP = dict(rtol=1e-5, atol=1e-6)
AFTER = dict(rtol=1e-4, atol=1e-5)


# --------------------------------------------------------- field functions

@pytest.mark.parametrize("name", ["sign_flip", "sign_flip_column",
                                  "rotate_field", "distort_field"])
def test_field_function_matches_reference(name):
    rng = np.random.default_rng(3)
    eig = rng.normal(size=(40, 4)).astype(np.float32)
    mask = rng.random(40) < 0.8
    key = jax.random.PRNGKey(11)
    shape = eig.shape if name == "sign_flip" else eig.shape[:1]
    u = np.array(jax.random.uniform(key, shape))
    je, te = jnp.asarray(eig), torch.from_numpy(eig)
    tu = torch.from_numpy(u)
    if name == "sign_flip":
        want, got = jfield.sign_flip(je, key), tfield.sign_flip(te, tu)
    elif name == "sign_flip_column":
        want = jfield.sign_flip_column(je, key)
        got = tfield.sign_flip_column(te, tu)
    elif name == "rotate_field":
        want = jfield.rotate_field(je, key, 15.0)
        got = tfield.rotate_field(te, tu, 15.0)
    else:
        want = jfield.distort_field(je, key, 0.1, node_mask=jnp.asarray(mask))
        got = tfield.distort_field(te, tu, 0.1,
                                   node_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FIELD)
    assert not np.array_equal(got.numpy(), eig)
    untouched = [c for c in range(4) if not (
        name == "sign_flip" or (c == 2 and name == "sign_flip_column")
        or (c in (1, 2) and name in ("rotate_field", "distort_field")))]
    np.testing.assert_array_equal(got.numpy()[:, untouched],
                                  eig[:, untouched])


# ------------------------------------------------------ augmented Adam step

def _reference_draws(rng_key, eig_shape) -> AugDraws:
    """The uniforms dgn_tpu's _train_step_impl draws from rng_key: its
    augmentation key is the first half of the split, then one key each for
    rotate, flip and distort (trainer.py:58-68, :147)."""
    aug_rng, _ = jax.random.split(rng_key)
    k1, k2, k3 = jax.random.split(aug_rng, 3)
    n = eig_shape[0]

    def t(x):
        return torch.from_numpy(np.array(x))

    return AugDraws(rotate=t(jax.random.uniform(k1, (n,))),
                    flip=t(jax.random.uniform(k2, eig_shape)),
                    distort=t(jax.random.uniform(k3, (n,))))


@pytest.fixture(scope="module")
def zinc_every_option():
    graphs = jsyn.synthetic_zinc(12, seed=31)
    for g in graphs:                   # as load_zinc stores it
        g.pos_enc = g.eig[:, 1:P + 1]
    degs = np.concatenate([np.bincount(g.dst, minlength=g.num_nodes)
                           for g in graphs])
    net = dict(hidden_dim=10, out_dim=10, L=2, type_net="towers", towers=2,
               divide_input=False, divide_input_last=True,
               posttrans_layers=2, virtual_node="mean", pos_enc_dim=P,
               aggregators="mean dir1-dx dir1-av", avg_d=degree_stats(degs))
    return graphs, net


@pytest.mark.parametrize("micro_batches", [1, 2])
def test_augmented_step_matches_reference(zinc_every_option, micro_batches):
    graphs, net = zinc_every_option
    jmodel, jloss = jzinc(JConfig(**net))
    jtrainer = JTrainer(jmodel, jloss, JParams(seed=41, init_lr=LR, **AUG),
                        task="zinc", donate=False)
    jbatch = next(iter(JBatchLoader(graphs, 12, layout="mxu",
                                    micro_batches=micro_batches)))
    first = jbatch[0] if micro_batches > 1 else jbatch
    variables = run_jitted(
        lambda key: jmodel.init(key, first, deterministic=True),
        jax.random.PRNGKey(41))
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=jtrainer.tx.init(variables["params"]),
                       step=jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(7)
    jstate, jl, jscores = run_jitted(
        jtrainer._train_step_impl, state, jbatch, key,
        jnp.asarray(LR, jnp.float32))

    tgs = [tgraph.GraphData(**dataclasses.asdict(g)) for g in graphs]
    tbatch = next(iter(TBatchLoader(tgs, 12, layout="mxu",
                                       micro_batches=micro_batches)))
    micros = tbatch if micro_batches > 1 else [tbatch]
    model, loss_fn = tzinc(TConfig(**net), torch.Generator().manual_seed(0),
                           pos_enc_in=P)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, state.params),
                    jax.tree_util.tree_map(np.asarray, state.batch_stats))
    trainer = TTrainer(model, loss_fn, TParams(seed=41, init_lr=LR, **AUG),
                       task="zinc", device="cpu")
    loss, scores = trainer.train_step(
        tbatch, aug=_reference_draws(key, tuple(micros[0].eig.shape)))

    np.testing.assert_allclose(float(loss), float(jl), **STEP)
    scores = scores if micro_batches > 1 else [scores]
    jscores = np.asarray(jscores).reshape((micro_batches, -1, 1))
    for tb, got, want in zip(micros, scores, jscores):
        gmask = tb.graph_mask.numpy()
        np.testing.assert_allclose(got.numpy()[gmask], want[gmask], **STEP)
    for got, tree in ((model.named_parameters(), jstate.params),
                      (model.named_buffers(), jstate.batch_stats)):
        want = flatten(jax.tree_util.tree_map(np.asarray, tree))
        got = {flax_path(k): v.detach().numpy() for k, v in got}
        assert set(got) == set(want)
        for path in want:
            np.testing.assert_allclose(got[path], want[path], err_msg=path,
                                       **AFTER)


# ------------------------------------------------ where the eig goes

def _eig_seen(monkeypatch, trainer, batch, step):
    seen = []
    build = agg_ops.build_edge_context

    def recording(eig, *args, **kwargs):
        seen.append(eig.detach().clone())
        return build(eig, *args, **kwargs)

    monkeypatch.setattr(agg_ops, "build_edge_context", recording)
    step(batch)
    monkeypatch.setattr(agg_ops, "build_edge_context", build)
    return seen


@pytest.mark.parametrize("augment", [True, False], ids=["on", "off"])
def test_train_step_builds_its_context_from_the_augmented_eig(monkeypatch,
                                                              augment):
    """With augmentation on, the eig that reaches build_edge_context in a
    train step is the augmented one; with it off, and in every eval step,
    it is the batch's."""
    graphs = [tgraph.GraphData(**dataclasses.asdict(g))
              for g in jsyn.synthetic_zinc(6, seed=2)]
    batch = next(iter(TBatchLoader(graphs, 6, layout="mxu", micro_batches=2)))
    params = TParams(seed=41, **(AUG if augment else {}))
    model, loss_fn = tzinc(TConfig(hidden_dim=6, out_dim=6, L=1),
                           torch.Generator().manual_seed(0))
    trainer = TTrainer(model, loss_fn, params, task="zinc", device="cpu")
    seen = _eig_seen(monkeypatch, trainer, batch, trainer.train_step)
    assert len(seen) == 2                  # one context per micro-batch
    for gb, eig in zip(batch, seen):
        assert torch.equal(eig, gb.eig) != augment
    seen = _eig_seen(monkeypatch, trainer, batch[0], trainer.eval_step)
    assert len(seen) == 1 and torch.equal(seen[0], batch[0].eig)


def test_augmentation_draws_from_its_own_seeded_generator():
    """Two trainers with one seed draw the same augmentation; the draws
    leave the dropout generator where it was; draws handed in for params
    that augment nothing raise."""
    graphs = [tgraph.GraphData(**dataclasses.asdict(g))
              for g in jsyn.synthetic_zinc(4, seed=3)]
    tb = tgraph.pack_graphs(graphs, mxu_layout=True)
    cfg = TConfig(hidden_dim=6, out_dim=6, L=1)
    outs = []
    for _ in range(2):
        model, loss_fn = tzinc(cfg, torch.Generator().manual_seed(0))
        trainer = TTrainer(model, loss_fn, TParams(seed=41, **AUG),
                           task="zinc", device="cpu")
        dropout_state = trainer.dropout_generator.get_state()
        aug_state = trainer.aug_generator.get_state()
        outs.append(trainer.train_step(tb)[1])
        assert torch.equal(trainer.dropout_generator.get_state(),
                           dropout_state)
        assert not torch.equal(trainer.aug_generator.get_state(), aug_state)
    assert torch.equal(outs[0], outs[1])
    model, loss_fn = tzinc(cfg, torch.Generator().manual_seed(0))
    plain = TTrainer(model, loss_fn, TParams(seed=41), task="zinc",
                     device="cpu")
    with pytest.raises(ValueError, match="augment"):
        plain.train_step(tb, aug=AugDraws(flip=torch.rand(tb.eig.shape)))
