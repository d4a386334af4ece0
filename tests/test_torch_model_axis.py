"""The 'model' mesh axis of the port against ffrnet_tpu: the class-sharded
CosFace head, the sharded softmax cross-entropy and argmax, and the pad
functions over the port's TrainState.

  * add_margin_logits / arc_margin_logits on each shard of a 13-class
    weight padded to 14 (2 shards) and 16 (4 shards), with the shard's
    offset, concatenated: ffrnet_tpu's unpadded head within 1e-6 (the JAX
    package's logits bound, tests/test_training.py:598-631); padded logits
    -1e5 and cosines -2
  * four gloo processes (tests/torch_distributed_worker.py `head`) run
    cross_entropy + mse(feat, target) over 2 and 4 shards: the loss within
    1e-5 rel (TotalLoss, tests/test_training.py:716), the argmax equal
    (a tie across a shard boundary goes to the lower index), the feature's
    gradient and each shard's weight gradient within 2e-5 of jax.grad of
    the unpadded loss (the parameter bound after one SGD update at lr 1),
    the padded rows' gradient exactly 0; a copy without the model-group
    gradient sum and a copy with each shard's softmax alone miss the bound
  * padded_num_classes and class_shard against ffrnet_tpu's
    padded_num_classes and the placement of P('model', None); the pad /
    unpad round trip of the classifier and its moments against
    ffrnet_tpu's pad_train_state_classes / unpad_train_state_classes on the
    same weights (Adam, AdaBound, and the 30-class head whose padded (32,
    512) moments share lin2's shape, tests/test_training.py:634-681)
"""

import copy
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ffrnet_torch import parallel
from ffrnet_torch.checkpoint.convert import train_state_dicts
from ffrnet_torch.models import recnet as t_recnet
from ffrnet_torch.models.recnet import RecNetConfig
from ffrnet_torch.training import trainer
from ffrnet_tpu.models import recnet as j_recnet
from ffrnet_tpu.models.recnet import RecNetConfig as JRecNetConfig
from ffrnet_tpu.parallel.mesh import make_mesh as j_make_mesh
from ffrnet_tpu.training import losses as j_losses
from ffrnet_tpu.training import trainer as j_trainer
from torch_distributed_worker import join_ranks, start_ranks

torch.set_num_threads(1)

NUM, N, S, M = 13, 6, 30.0, 0.40
LOGIT_TOL = 1e-6        # the JAX package's logits bound
LOSS_RTOL = 1e-5        # TotalLoss
GRAD_TOL = 2e-5         # the parameter bound after one SGD update, at lr 1
TIES = {2: (6, 7), 4: (3, 4)}  # rows equal across the shard boundary of 2 / 4 shards


def head_inputs(seed=0):
    """13 classes, 6 samples; rows 6, 7 are e0 and rows 3, 4 e1, so samples
    0 (2 e0) and 1 (2 e1) have exactly tied cosines 1.0 across the 2- and
    the 4-shard boundary."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((NUM, 512)).astype(np.float32)
    feat = rng.standard_normal((N, 512)).astype(np.float32)
    for rows, axis, sample in ((TIES[2], 0, 0), (TIES[4], 1, 1)):
        e = np.zeros(512, np.float32)
        e[axis] = 1.0
        w[list(rows)] = e
        feat[sample] = 2 * e
    label = np.array([1, 12, 5, 7, 0, 6])
    target = rng.standard_normal((N, 512)).astype(np.float32)
    return w, feat, label, target


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("kind", ["add", "arc"])
def test_shard_logits_match_jax_unpadded_head(kind, n_model):
    w, feat, label, _ = head_inputs()
    j_fn, t_fn = ((j_recnet.add_margin_logits, t_recnet.add_margin_logits) if kind == "add"
                  else (j_recnet.arc_margin_logits, t_recnet.arc_margin_logits))
    kw = dict(s=S, m=M) if kind == "add" else dict(s=S, m=0.5)
    want_l, want_c = (np.asarray(a) for a in j_fn(jnp.asarray(w), jnp.asarray(feat),
                                                  jnp.asarray(label), num_classes=NUM, **kw))
    padded = parallel.padded_num_classes(NUM, n_model)
    wp = torch.cat([_t(w), torch.zeros(padded - NUM, 512)])
    logits, cosines = [], []
    for j in range(n_model):
        off, rows = parallel.class_shard(NUM, n_model, j)
        lg, cs = t_fn(wp[off:off + rows], _t(feat), _t(label), num_classes=NUM, offset=off, **kw)
        assert lg.shape == cs.shape == (N, rows)
        logits.append(lg)
        cosines.append(cs)
    logits, cosines = torch.cat(logits, 1).numpy(), torch.cat(cosines, 1).numpy()
    np.testing.assert_allclose(cosines[:, :NUM], want_c, atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(logits[:, :NUM], want_l, atol=LOGIT_TOL, rtol=0)
    assert (logits[:, NUM:] == -1e5).all() and (cosines[:, NUM:] == -2.0).all()


@pytest.fixture(scope="module")
def head_runs(tmp_path_factory):
    """(the 4 ranks' results, the JAX reference: loss, argmax, feature and
    weight gradients of the unpadded head)."""
    out = str(tmp_path_factory.mktemp("head"))
    w, feat, label, target = head_inputs()
    torch.save({"w": _t(w), "feat": _t(feat), "label": _t(label), "target": _t(target),
                "s": S, "m": M}, os.path.join(out, "inputs.pt"))
    procs = start_ranks("head", out, world=4)

    def loss(feat, w):
        logits, _ = j_recnet.add_margin_logits(w, feat, jnp.asarray(label), s=S, m=M,
                                               num_classes=NUM)
        return (j_losses.cross_entropy(logits, jnp.asarray(label))
                + j_losses.mse(feat, jnp.asarray(target)))

    value, (g_feat, g_w) = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(feat),
                                                                    jnp.asarray(w))
    _, cosine = j_recnet.add_margin_logits(jnp.asarray(w), jnp.asarray(feat), jnp.asarray(label),
                                           s=S, m=M, num_classes=NUM)
    want = {"loss": float(value), "argmax": np.asarray(jnp.argmax(cosine, axis=1)),
            "feat_grad": np.asarray(g_feat), "w_grad": np.asarray(g_w)}
    join_ranks(procs)
    got = [torch.load(os.path.join(out, f"head.{r}.pt"), weights_only=False) for r in range(4)]
    return got, want


def _misses(res, want):
    """The largest excess over its bound of the loss, the feature gradient
    and the unpadded weight gradient of one rank's result (> 0: out)."""
    off, wg = res["offset"], res["w_grad"].numpy()
    real = max(min(wg.shape[0], NUM - off), 0)
    return max(abs(float(res["loss"]) - want["loss"]) - LOSS_RTOL * abs(want["loss"]),
               np.abs(res["feat_grad"].numpy() - want["feat_grad"]).max() - GRAD_TOL,
               np.abs(wg[:real] - want["w_grad"][off:off + real]).max() - GRAD_TOL)


@pytest.mark.parametrize("n_model", [2, 4])
def test_sharded_loss_and_gradients_match_jax(head_runs, n_model):
    got, want = head_runs
    for r, res in enumerate(g[n_model, "sharded"] for g in got):
        np.testing.assert_allclose(float(res["loss"]), want["loss"], rtol=LOSS_RTOL, err_msg=r)
        np.testing.assert_allclose(res["feat_grad"].numpy(), want["feat_grad"], atol=GRAD_TOL,
                                   rtol=0, err_msg=f"rank {r}")
        off, wg = res["offset"], res["w_grad"]
        real = max(min(wg.shape[0], NUM - off), 0)
        np.testing.assert_allclose(wg[:real].numpy(), want["w_grad"][off:off + real],
                                   atol=GRAD_TOL, rtol=0, err_msg=f"rank {r}")
        assert torch.count_nonzero(wg[real:]) == 0  # the padded rows: exactly zero
        assert _misses(res, want) <= 0
    # every rank of a model group reports the same loss and feature gradient
    for a, b in zip(got, got[1:]):
        assert torch.equal(a[n_model, "sharded"]["loss"], b[n_model, "sharded"]["loss"])
        assert torch.equal(a[n_model, "sharded"]["feat_grad"],
                           b[n_model, "sharded"]["feat_grad"])


@pytest.mark.parametrize("n_model", [2, 4])
def test_sharded_argmax_takes_the_lower_index_of_a_tie(head_runs, n_model):
    got, want = head_runs
    assert want["argmax"][0] == TIES[2][0] and want["argmax"][1] == TIES[4][0]
    a, b = TIES[n_model]
    off_b = parallel.class_shard(NUM, n_model, 1)[0]
    assert a < off_b <= b  # the tie straddles a shard boundary
    for g in got:
        np.testing.assert_array_equal(g[n_model, "sharded"]["argmax"].numpy(), want["argmax"])
        acc = (g[n_model, "sharded"]["argmax"].numpy() == head_inputs()[2]).mean()
        np.testing.assert_allclose(acc, (want["argmax"] == head_inputs()[2]).mean(), atol=1e-6)


@pytest.mark.parametrize("variant", ["no_copy", "local_softmax"])
def test_controls_miss_the_bound(head_runs, variant):
    """Without the model group's gradient sum the feature's gradient lacks
    the other shards' share; with each shard's softmax alone the loss and
    both gradients are another function's. Either misses on every rank."""
    got, want = head_runs
    for n_model in (2, 4):
        for g in got:
            assert _misses(g[n_model, variant], want) > 1e-3, (variant, n_model)


# ----------------------------------------------------------- pad and shard


@pytest.mark.parametrize("num,n_model", [(10575, m) for m in range(1, 9)] + [(10576, 8)])
def test_padded_num_classes_matches_jax(num, n_model):
    assert parallel.padded_num_classes(num, n_model) == j_trainer.padded_num_classes(num, n_model)
    assert trainer.padded_num_classes is parallel.padded_num_classes


@pytest.mark.parametrize("num,n_model", [(13, 2), (13, 4), (10575, 2)])
def test_class_shard_matches_jax_placement(num, n_model):
    """Model rank j's rows are the rows that P('model', None) places on the
    devices of model coordinate j of the JAX package's mesh."""
    mesh = j_make_mesh(n_data=2, n_model=n_model, devices=jax.devices()[:2 * n_model])
    padded = j_trainer.padded_num_classes(num, n_model)
    where = NamedSharding(mesh, P("model", None)).devices_indices_map((padded, 512))
    for (d, j), dev in np.ndenumerate(mesh.devices):
        rows = where[dev][0]
        off, n = parallel.class_shard(num, n_model, j)
        assert (rows.start or 0, rows.stop or padded) == (off, off + n), (d, j)


def _states(optimizer, num, seed=0):
    """A JAX TrainState whose optimizer moments are noise (nonzero, so a
    moment that a pad misses shows) and the port's state carried over from
    it by checkpoint.convert.train_state_dicts."""
    cfg = j_trainer.TrainerConfig(optimizer=optimizer, lr=1e-3,
                                  recnet=JRecNetConfig(num_classes=num))
    js = jax.device_get(jax.jit(functools.partial(j_trainer.create_train_state, cfg=cfg))(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    opt = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(x.dtype)
                       if hasattr(x, "dtype") and x.dtype == np.float32 and x.ndim else x,
                       js.opt_state)
    js = j_trainer.TrainState(js.params, js.model_state, opt, js.step)
    rec_sd, opt_sd, step = train_state_dicts(*tuple(js), optimizer=optimizer)
    tcfg = trainer.TrainerConfig(optimizer=optimizer, lr=1e-3,
                                 recnet=RecNetConfig(num_classes=num))
    ts = trainer.load_train_state(trainer.create_train_state(tcfg, device="cpu"), rec_sd,
                                  opt_sd, step)
    return js, ts


def _port_view(state):
    """The port's state as the trees train_state_dicts gives for JAX's."""
    from ffrnet_torch.checkpoint.store import optimizer_state_by_key

    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    return sd, optimizer_state_by_key(state.model, state.optimizer.inner)


def _assert_trees_equal(a, b):
    (sd_a, opt_a), (sd_b, opt_b) = a, b
    assert sd_a.keys() == sd_b.keys() and opt_a.keys() == opt_b.keys()
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    for k in opt_a:
        assert opt_a[k].keys() == opt_b[k].keys(), k
        for e in opt_a[k]:
            va, vb = opt_a[k][e], opt_b[k][e]
            assert (torch.equal(va, vb) if isinstance(va, torch.Tensor) else va == vb), (k, e)


@pytest.mark.parametrize("optimizer,num,rows", [("adam", 13, 16), ("adabound", 13, 16),
                                                ("adam", 30, 32)])
def test_pad_unpad_round_trip_matches_jax(optimizer, num, rows):
    """pad_train_state_classes on the carried-over state equals the JAX
    package's on the same weights (the classifier and every moment that
    mirrors it padded with zero rows, nothing else touched), and unpad
    restores the state bit for bit; 30 classes padded to 32 leave lin2's
    (32, 512) moments alone."""
    js, ts = _states(optimizer, num)
    before = _port_view(ts)
    jp = j_trainer.pad_train_state_classes(js, rows)
    want = train_state_dicts(*tuple(jax.device_get(jp)), optimizer=optimizer)
    padded = trainer.pad_train_state_classes(ts, rows)
    assert padded is ts and ts.model.classifier.weight.shape == (rows, 512)
    got = _port_view(ts)
    _assert_trees_equal(got, want[:2])
    cls_moments = [v for v in got[1]["classifier.weight"].values()
                   if isinstance(v, torch.Tensor) and v.ndim]
    assert cls_moments and all(v.shape == (rows, 512) for v in cls_moments)
    lin2 = [v for k, st in got[1].items() if k == "Conv4Channel.3.weight"
            for v in st.values() if isinstance(v, torch.Tensor) and v.ndim == 2]
    assert lin2 and all(v.shape == (32, 512) for v in lin2)
    assert trainer.unpad_train_state_classes(ts, num) is ts
    _assert_trees_equal(_port_view(ts), before)
    # no-op at the target size
    assert trainer.pad_train_state_classes(ts, num) is ts
    _assert_trees_equal(_port_view(ts), before)
    with pytest.raises(ValueError, match="rows > target"):
        trainer.pad_train_state_classes(copy.deepcopy(ts), num - 1)
