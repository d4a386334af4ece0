"""ffrnet_torch.training and RecNet's train mode vs ffrnet_tpu on the CPU.

The objective, the schedule, the four optimizers (clip, L2 weight decay,
nesterov) on gradient sequences, the optimizer state carried across from
optax, both margin heads (padded and not), train-mode BN, and RecNet's
train forward at C=512 with its new BN state. JAX weights reach the port
through ffrnet_torch.checkpoint.convert; inputs are made with numpy from a
seed. fp32 unless a test says otherwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ffrnet_torch.checkpoint.convert import optimizer_state_dict, recnet_state_dict
from ffrnet_torch.data.datasets import SyntheticPairs
from ffrnet_torch.models import layers as t_layers
from ffrnet_torch.models import recnet as t_recnet
from ffrnet_torch.ops import nn as t_ops
from ffrnet_torch.training import losses as t_losses
from ffrnet_torch.training import optimizers as t_opt
from ffrnet_torch.training import schedules as t_sched
from ffrnet_torch.training.trainer import (TrainerConfig, TrainState, create_train_state,
                                           load_train_state, train_step_from_features)
from ffrnet_tpu.data.datasets import SyntheticPairs as JSyntheticPairs
from ffrnet_tpu.models import recnet as j_recnet
from ffrnet_tpu.ops import nn as j_ops
from ffrnet_tpu.training import losses as j_losses
from ffrnet_tpu.training import optimizers as j_opt
from ffrnet_tpu.training import schedules as j_sched

torch.set_num_threads(1)

OPTS = ("adam", "sgd", "sgd_nesterov", "rmsprop", "adabound")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _nchw(a):
    return _t(np.asarray(a).transpose(0, 3, 1, 2))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------- schedules


def test_multistep_schedule_matches_torch_and_jax():
    lin = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(lin.parameters(), lr=0.5)
    sch = torch.optim.lr_scheduler.MultiStepLR(opt, [3, 6, 9], gamma=0.5)
    ours = t_sched.multistep_lr(0.5, [9, 3, 6], 0.5)
    theirs = j_sched.multistep_lr(0.5, [3, 6, 9], 0.5)
    for c in range(12):
        assert ours(c) == opt.param_groups[0]["lr"]
        assert ours(c) == pytest.approx(float(theirs(c)), rel=1e-7)
        opt.step()
        sch.step()
    assert t_sched.constant_lr(0.25)(100) == 0.25


# --------------------------------------------------------------- optimizers


def _opt_kw(name):
    return dict(name=name.split("_")[0], nesterov=name.endswith("nesterov"),
                momentum=0.9, weight_decay=5e-4, clip_value=1.0)


@pytest.mark.parametrize("name", OPTS)
def test_optimizer_matches_jax(name):
    """Six updates on a gradient sequence: clip at 1.0 (the gradients reach
    +-3), L2 weight decay into the clipped gradient, and a milestone at the
    third update that halves the learning rate."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [1.5 * rng.standard_normal((4, 3)).astype(np.float32) for _ in range(6)]
    kw = _opt_kw(name)
    lr = 1e-3 if kw["name"] in ("adabound", "rmsprop") else 1e-2
    tx = j_opt.make_optimizer(kw["name"], j_sched.multistep_lr(lr, (3,), 0.5),
                              momentum=kw["momentum"], weight_decay=kw["weight_decay"],
                              nesterov=kw["nesterov"], clip_value=1.0, base_lr=lr)
    params = {"w": jnp.asarray(w0)}
    st = tx.init(params)
    p = torch.nn.Parameter(_t(w0.copy()))
    opt = t_opt.make_optimizer(kw["name"], [p], t_sched.multistep_lr(lr, (3,), 0.5),
                               momentum=kw["momentum"], weight_decay=kw["weight_decay"],
                               nesterov=kw["nesterov"], clip_value=1.0, base_lr=lr)
    for i, g in enumerate(grads):
        upd, st = tx.update({"w": jnp.asarray(g)}, st, params)
        params = optax.apply_updates(params, upd)
        p.grad = _t(g.copy())
        assert opt.step(i) == pytest.approx(lr * 0.5 ** (i >= 3))
        # optax and torch.optim order Adam's m / (sqrt(v) + eps) differently:
        # atol 1e-6 (the JAX package's own bound for optax vs torch.optim)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["w"]), rtol=1e-6,
                                   atol=1e-6, err_msg=f"update {i}")


def test_clip_value_composes():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = t_opt.make_optimizer("sgd", [p], 1.0, momentum=0.0, clip_value=1.0)
    p.grad = torch.tensor([5.0, -7.0, 0.5])
    opt.step(0)
    np.testing.assert_array_equal(p.detach().numpy(), [-1.0, 1.0, -0.5])


@pytest.fixture(scope="module")
def jax_recnet_tree():
    init = jax.jit(lambda key: j_recnet.init(key, j_recnet.RecNetConfig(num_classes=8)))
    return jax.device_get(init(jax.random.PRNGKey(1)))


@pytest.fixture(scope="module")
def small_tree():
    """A RecNet tree at C=64 (the keys and layouts of C=512 at 1/64 of the
    size): shapes from the JAX init, values from numpy."""
    shapes = jax.eval_shape(lambda: j_recnet.init(
        jax.random.PRNGKey(0), j_recnet.RecNetConfig(channel=64, num_classes=8)))
    rng = np.random.default_rng(2)
    return jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("name", OPTS)
def test_optimizer_state_carried_across(small_tree, name):
    """Two optax updates of a RecNet tree, the state carried across by
    checkpoint.convert, then the third update in each package."""
    params, mstate = small_tree
    kw = _opt_kw(name)
    lr = 1e-3
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda a: (0.5 * rng.standard_normal(a.shape)).astype(np.float32),
                          params) for _ in range(3)]
    tx = j_opt.make_optimizer(kw["name"], j_sched.multistep_lr(lr, (2,), 0.5),
                              momentum=kw["momentum"], weight_decay=kw["weight_decay"],
                              nesterov=kw["nesterov"], base_lr=lr)

    def run(p, gs):
        st = tx.init(p)
        for g in gs[:2]:
            upd, st = tx.update(g, st, p)
            p = optax.apply_updates(p, upd)
        upd, _ = tx.update(gs[2], st, p)
        return p, st, optax.apply_updates(p, upd)

    p2, st2, p3 = jax.device_get(jax.jit(run)(params, grads))
    cfg = TrainerConfig(optimizer=kw["name"], lr=lr, milestones=(2,), momentum=kw["momentum"],
                        weight_decay=kw["weight_decay"], nesterov=kw["nesterov"],
                        recnet=t_recnet.RecNetConfig(channel=64, num_classes=8))
    state = create_train_state(cfg, device="cpu")
    load_train_state(state, recnet_state_dict(p2, mstate),
                     optimizer_state_dict(kw["name"], st2, 2), 2)
    assert state.step == 2
    want = recnet_state_dict(p3)
    g3 = recnet_state_dict(grads[2])
    named = dict(state.model.named_parameters())
    for k, t in named.items():
        t.grad = g3[k].clone()
    assert state.optimizer.step(state.step) == pytest.approx(lr * 0.5)
    assert set(want) == set(named)
    for k, t in named.items():
        np.testing.assert_allclose(t.detach().numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


# ------------------------------------------------------------- margin heads


@pytest.mark.parametrize("head", ["add", "arc"])
@pytest.mark.parametrize("padded", [False, True])
def test_margin_heads_match_jax(head, padded):
    """Logits, cosines, CE and its gradients vs JAX; a weight padded from 13
    to 16 rows gives the unpadded CE, padded rows get exactly zero gradient
    and stay zero under Adam."""
    rng = np.random.default_rng(0)
    n_cls, rows = 13, 16 if padded else 13
    w = np.zeros((rows, 512), np.float32)
    w[:n_cls] = rng.standard_normal((n_cls, 512))
    feat = rng.standard_normal((4, 512)).astype(np.float32)
    label = np.array([0, 5, 12, 3])
    fj, ft = ((j_recnet.add_margin_logits, t_recnet.add_margin_logits) if head == "add"
              else (j_recnet.arc_margin_logits, t_recnet.arc_margin_logits))
    kw = dict(s=30.0, m=0.40 if head == "add" else 0.50, num_classes=n_cls)

    def j_ce(ww, ff):
        logits, cos = fj(ww, ff, jnp.asarray(label), **kw)
        return j_losses.cross_entropy(logits, jnp.asarray(label)), (logits, cos)

    (ce_j, (logits_j, cos_j)), (gw_j, gf_j) = jax.jit(jax.value_and_grad(
        j_ce, argnums=(0, 1), has_aux=True))(jnp.asarray(w), jnp.asarray(feat))
    wt, feat_t = _t(w).requires_grad_(), _t(feat).requires_grad_()
    logits, cos = ft(wt, feat_t, _t(label), **kw)
    ce = t_losses.cross_entropy(logits, _t(label))
    ce.backward()
    # fp32; logits are 30x the cosines
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j), atol=3e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(cos.detach().numpy(), np.asarray(cos_j), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ce.item(), float(ce_j),
                               rtol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(feat_t.grad.numpy(), np.asarray(gf_j), atol=1e-6, rtol=1e-5)
    assert np.isfinite(wt.grad.numpy()).all() and np.isfinite(feat_t.grad.numpy()).all()
    if padded:
        assert (wt.grad[n_cls:] == 0).all() and (wt.grad[:n_cls] != 0).any()
        assert (cos[:, n_cls:] == -2).all() and (logits[:, n_cls:] == -1e5).all()
        lo, co = ft(wt[:n_cls], feat_t, _t(label), **kw)
        np.testing.assert_allclose(ce.item(), t_losses.cross_entropy(lo, _t(label)).item(),
                                   rtol=1e-6)
        assert (cos.argmax(1) == co.argmax(1)).all()
        p = torch.nn.Parameter(_t(w))
        opt = t_opt.make_optimizer("adam", [p], 1e-2)
        for i in range(2):
            opt.zero_grad()
            t_losses.cross_entropy(ft(p, feat_t.detach(), _t(label), **kw)[0], _t(label)).backward()
            opt.step(i)
        assert (p[n_cls:] == 0).all()


# ----------------------------------------------------------------------- BN


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_matches_jax(dtype):
    """Two successive train-mode calls, the running stats threaded through:
    outputs, running stats (fp32 whatever x's type) and the input
    gradient."""
    rng = np.random.default_rng(2)
    xs = [rng.normal(0.5, 2.0, (4, 5, 5, 64)).astype(np.float32) for _ in range(2)]
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rng.normal(0, 0.1, 64).astype(np.float32)
    mean_j, var_j = np.zeros(64, np.float32), np.ones(64, np.float32)
    mean_t, var_t = torch.zeros(64), torch.ones(64)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
              else (jnp.float32, torch.float32))
    # fp32: 1e-6 after normalization; bf16: one rounding of y at 8 bits
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == "float32" else dict(atol=3e-2, rtol=1e-2)
    for x in xs:
        y_j, mean_j, var_j = j_ops.batch_norm(jnp.asarray(x, jd), scale, bias, mean_j, var_j,
                                              training=True)
        xt = _nchw(x).to(td).requires_grad_()
        y_t, mean_t, var_t = t_ops.batch_norm_train(xt, _t(scale), _t(bias), mean_t, var_t)
        np.testing.assert_allclose(_nhwc(y_t.float()), np.asarray(y_j, np.float32), **tol)
        assert mean_t.dtype == var_t.dtype == torch.float32
        np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), atol=1e-6, rtol=1e-6)
    g = rng.standard_normal(xs[0].shape).astype(np.float32)
    gx_j = jax.grad(lambda a: jnp.sum(j_ops.batch_norm(a, scale, bias, mean_j, var_j,
                                                       training=True)[0] * g))(jnp.asarray(xs[0]))
    xt = _nchw(xs[0]).requires_grad_()
    (t_ops.batch_norm_train(xt, _t(scale), _t(bias), mean_t, var_t)[0] * _nchw(g)).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx_j), atol=1e-5, rtol=1e-5)


def test_norm_layer_follows_train_mode():
    """Train mode moves the running stats in place, unless
    running_stats_frozen holds them; eval mode reads them."""
    layer = t_layers.NormLayer(8, "bn").train()
    x = torch.from_numpy(np.random.default_rng(3).normal(2.0, 3.0, (4, 8, 3, 3))
                         .astype(np.float32))
    y, mean, var = t_ops.batch_norm_train(x, layer.norm.weight, layer.norm.bias,
                                          torch.zeros(8), torch.ones(8))
    with t_layers.running_stats_frozen(layer):
        torch.testing.assert_close(layer(x), y, rtol=0, atol=0)
    assert (layer.norm.running_mean == 0).all() and layer.update_stats
    layer(x)
    torch.testing.assert_close(layer.norm.running_mean, mean, rtol=0, atol=0)
    torch.testing.assert_close(layer.norm.running_var, var, rtol=0, atol=0)
    assert int(layer.norm.num_batches_tracked) == 0
    layer.eval()
    torch.testing.assert_close(layer(x), t_ops.batch_norm(x, layer.norm.weight, layer.norm.bias,
                                                          mean, var), rtol=0, atol=0)


# ---------------------------------------------------------------- objective


def _fake_outs(n, classes, seed):
    """Two branches' outputs as (JAX RecNetTrainOut NHWC, port NCHW)."""
    r = np.random.default_rng(seed)
    outs = []
    for _ in range(2):
        a = {"feat_new_v": r.standard_normal((n, 512)), "logits": 5 * r.standard_normal((n, classes)),
             "cosine": r.uniform(-1, 1, (n, classes)), "m_space": r.uniform(0, 1, (n, 49, 49)),
             "m_channel": r.uniform(0, 1, (n, 512, 512)),
             "feat_space": r.standard_normal((n, 7, 7, 512)),
             "feat_channel": r.standard_normal((n, 7, 7, 512))}
        a = {k: v.astype(np.float32) for k, v in a.items()}
        outs.append(a)
    return outs


@pytest.mark.parametrize("case", ["factored", "materialized", "kernel", "weights_unfaithful"])
def test_objective_matches_jax(case):
    """Every LossBreakdown field, and the total's gradient to each rectified
    output, against ffrnet_objective on the same numbers."""
    n, classes = 3, 8
    rng = np.random.default_rng(4)
    fm = rng.standard_normal((n, 7, 7, 512)).astype(np.float32)
    emb = [rng.standard_normal((n, 512)).astype(np.float32) for _ in range(2)]
    labels = np.array([0, 5, 7])
    outs = _fake_outs(n, classes, 5)
    kw = dict(loss_weight=(1.0, 1.0, 1.0, 1.0), faithful_ce_weight=True,
              ss_loss_impl="factored" if case != "materialized" else "materialized")
    ss_j, ss_t = ("pallas", "kernel") if case == "kernel" else ("xla", "plain")
    if case == "weights_unfaithful":
        kw.update(loss_weight=(0.5, 2.0, 1.5, 0.25), faithful_ce_weight=False)
    grad_keys = ("feat_new_v", "logits", "feat_space", "feat_channel")

    def j_total(*vals):
        o = []
        for b in range(2):
            d = dict(outs[b])
            d.update(zip(grad_keys, vals[4 * b:4 * b + 4]))
            o.append(j_recnet.RecNetTrainOut(**{k: jnp.asarray(v) for k, v in d.items()}))
        lb = j_losses.ffrnet_objective(
            featmap_non=jnp.asarray(fm), embed_non=jnp.asarray(emb[0]),
            embed_ocl=jnp.asarray(emb[1]), out_non=o[0], out_ocl=o[1],
            labels=jnp.asarray(labels), ss_impl=ss_j, **kw)
        return lb.total, lb

    vals = [jnp.asarray(outs[b][k]) for b in range(2) for k in grad_keys]
    (_, lb_j), g_j = jax.jit(jax.value_and_grad(j_total, argnums=tuple(range(8)),
                                                has_aux=True))(*vals)
    leaves, t_outs = [], []
    for b in range(2):
        d = {}
        for k, v in outs[b].items():
            t = _nchw(v) if k in ("feat_space", "feat_channel") else _t(v)
            if k in grad_keys:
                t.requires_grad_()
            d[k] = t
        leaves += [d[k] for k in grad_keys]
        t_outs.append(t_recnet.RecNetTrainOut(**d))
    lb_t = t_losses.ffrnet_objective(featmap_non=_nchw(fm), embed_non=_t(emb[0]),
                                     embed_ocl=_t(emb[1]), out_non=t_outs[0], out_ocl=t_outs[1],
                                     labels=_t(labels), ss_impl=ss_t, **kw)
    lb_t.total.backward()
    for f in j_losses.LossBreakdown._fields:
        # fp32: the factored Gram MSE cancels three sums of about 1e3
        np.testing.assert_allclose(getattr(lb_t, f).item(), float(getattr(lb_j, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
    for leaf, g, k in zip(leaves, g_j, grad_keys * 2):
        got = _nhwc(leaf.grad) if k in ("feat_space", "feat_channel") else leaf.grad.numpy()
        g = np.asarray(g)
        np.testing.assert_allclose(got, g, atol=1e-5 * np.abs(g).max() + 1e-9, err_msg=k)


def test_gram_mse_factored_matches_materialized():
    rng = np.random.default_rng(5)
    a, b = (_t(rng.standard_normal((3, 512, 49)).astype(np.float32)) for _ in range(2))
    want = t_losses.mse(t_losses.cosine_sim(a, a), t_losses.cosine_sim(b, b))
    assert float(t_losses.gram_mse_factored(a, b)) == pytest.approx(float(want), rel=1e-5)


# ------------------------------------------------------- RecNet train mode


_TRAIN_CONFIGS = {
    "factored": (t_recnet.RecNetConfig(num_classes=8), j_recnet.RecNetConfig(num_classes=8)),
    "ss_kernel": (dataclasses.replace(t_recnet.SS_KERNEL_CONFIG, num_classes=8),
                  j_recnet.RecNetConfig(num_classes=8, ss_impl="pallas",
                                        c4c_impl="materialized")),
}


@pytest.mark.parametrize("name", sorted(_TRAIN_CONFIGS))
def test_recnet_train_forward_matches_jax(jax_recnet_tree, name):
    """C=512, N=2, 8 classes, train mode: every RecNetTrainOut field and the
    running stats after the forward."""
    params, mstate = jax_recnet_tree
    t_cfg, j_cfg = _TRAIN_CONFIGS[name]
    fm = np.random.default_rng(6).standard_normal((2, 7, 7, 512)).astype(np.float32)
    label = np.array([3, 6])
    out_j, st_j = jax.jit(lambda f: j_recnet.apply(params, mstate, f, jnp.asarray(label),
                                                   cfg=j_cfg, training=True))(jnp.asarray(fm))
    model = t_recnet.build_recnet(t_cfg)
    model.load_state_dict(recnet_state_dict(params, mstate))
    model.train()
    with torch.no_grad():
        out_t = model(_nchw(fm), _t(label))
    assert isinstance(out_t, t_recnet.RecNetTrainOut)
    for f in t_recnet.RecNetTrainOut._fields:
        got = getattr(out_t, f)
        got = _nhwc(got) if f in ("feat_space", "feat_channel") else got.numpy()
        want = np.asarray(getattr(out_j, f))
        # fp32 through three conv chains in train mode; logits are 30x the
        # cosines
        atol = 3e-5 if f == "logits" else 1e-5
        np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5, err_msg=f)
    want_sd = recnet_state_dict(params, jax.device_get(st_j))
    got_sd = model.state_dict()
    stats = [k for k in want_sd if "running" in k]
    assert len(stats) == 2 * 15
    for k in stats:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
        # moved from the initial stats (means 0, variances 1)
        assert (got_sd[k] != (0.0 if k.endswith("mean") else 1.0)).any(), k


def test_train_mode_drops_collapsed_weights(jax_recnet_tree):
    """An eval after training must not use channel weights collapsed before
    an optimizer step."""
    model = t_recnet.build_recnet(t_recnet.RecNetConfig(num_classes=8))
    model.load_state_dict(recnet_state_dict(*jax_recnet_tree))
    assert model.collapse_channel_weights().channel_weights is not None
    model.train()
    assert model.channel_weights is None
    model.eval()
    assert model.channel_weights is None


@pytest.fixture(scope="module")
def features():
    rng = np.random.default_rng(0)
    fm = rng.standard_normal((2, 2, 512, 7, 7)).astype(np.float32)
    e = rng.standard_normal((2, 2, 512)).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    return {"featmap_non": fm[0], "featmap_ocl": fm[1], "embed_non": e[0],
            "embed_ocl": e[1], "label": np.array([0, 1])}


@pytest.mark.parametrize("mode", ["remat", "remat_channel", "both"])
def test_remat_matches_plain(features, mode):
    """torch.utils.checkpoint around the branches (remat) or the channel
    branch (remat_channel) reruns the forward in the backward pass: the same
    loss, parameters and running stats, which move once per branch."""
    base = TrainerConfig(optimizer="adam", lr=1e-3, recnet=t_recnet.RecNetConfig(num_classes=8))
    alt = dataclasses.replace(
        base, remat=mode != "remat_channel",
        recnet=t_recnet.RecNetConfig(num_classes=8, remat_channel=mode != "remat"))
    got = []
    for cfg in (base, alt):
        state = create_train_state(cfg, device="cpu")
        state, m = train_step_from_features(state, features, cfg=cfg)
        got.append((float(m["TotalLoss"]), state.model.state_dict()))
    assert got[0][0] == got[1][0]
    for k, v in got[0][1].items():
        torch.testing.assert_close(got[1][1][k], v, rtol=0, atol=0, msg=k)


def test_train_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        create_train_state(TrainerConfig())
    assert isinstance(create_train_state(
        TrainerConfig(recnet=t_recnet.RecNetConfig(num_classes=8)), device="cpu"), TrainState)


# --------------------------------------------------------------------- data


@pytest.mark.parametrize("host_normalize", [True, False])
def test_synthetic_pairs_match_jax(host_normalize):
    ours = SyntheticPairs(num_identities=5, samples_per_id=2, seed=3,
                          host_normalize=host_normalize)
    theirs = JSyntheticPairs(num_identities=5, samples_per_id=2, seed=3,
                             host_normalize=host_normalize)
    assert len(ours) == len(theirs) == 10
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for i in range(len(ours)):
        a, b = ours.get(i, r1), theirs.get(i, r2)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
