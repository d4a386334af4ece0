"""JAX-package weight trees -> the port's state dicts (reference key schema).

`backbone_state_dict` and `recnet_state_dict` take the numpy trees of
`ffrnet_tpu` (`irse.init`/`recnet.init` output after `jax.device_get`) and
return dicts of torch tensors under the reference's keys, which the port's
modules load with `load_state_dict`:

  * conv weights HWIO -> OIHW; a conv bias (a BN-folded tree) -> `.bias`
  * SE weights (out, in) -> (out, in, 1, 1)
  * Linear weights keep the torch (out, in) orientation
  * BN scale/bias/mean/var -> weight/bias/running_mean/running_var (and
    num_batches_tracked = 0)

`train_state_dicts` carries a JAX TrainState (params, model_state, the
optax opt_state, step) across: RecNet's state dict, and the optimizer's
moments per parameter key in torch.optim's names (Adam exp_avg/exp_avg_sq
from optax mu/nu, SGD momentum_buffer from trace, RMSprop square_avg and
momentum_buffer, AdaBound exp_avg/exp_avg_sq), so that a run started in
JAX takes the same next update in the port. `optimizer_state_from_leaves`
does the same from the flat optax leaves a JAX checkpoint stores
(`optimizer_tpu`), in the order jax.tree.leaves gives them: dict keys
sorted at every level (`recnet_param_tree` rebuilds that tree from a
RecNet state dict).

The model zoo's extras: `mobilefacenet_state_dict`, `hgblock_state_dict`,
`se_layer_state_dict` and `head_state_dict` (the Arcface / AmSoftmax
kernel, whose (embedding, classes) layout is the same in both packages).
Depthwise and grouped conv kernels (kh, kw, C/groups, C) go to (C,
C/groups, kh, kw) by the same transpose as any HWIO kernel.

The module takes plain numpy trees and imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ffrnet_torch.models.irse import unit_configs
from ffrnet_torch.models.mobilefacenet import _ARCH as MOBILEFACENET_ARCH

SD = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable copy


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _conv(out: SD, prefix: str, p: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    if p.get("b") is not None:
        out[f"{prefix}.bias"] = _t(p["b"])


def _bn(out: SD, prefix: str, params, state) -> None:
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    if state is None:  # a tree of parameters only
        return
    out[f"{prefix}.running_mean"] = _t(state["mean"])
    out[f"{prefix}.running_var"] = _t(state["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def backbone_state_dict(params, state, num_layers: int = 50,
                        mode: str = "ir_se") -> SD:
    """IR-SE tree -> Backbone state dict. Fails fast, as irse.apply does,
    when the tree's depth or SE blocks do not fit (num_layers, mode)."""
    units = unit_configs(num_layers)
    if len(params["body"]) != len(units):
        raise ValueError(
            f"params tree has {len(params['body'])} residual units but "
            f"num_layers={num_layers} expects {len(units)} — pass the "
            "num_layers the tree was initialized with")
    has_se = "se" in params["body"][0]["res"]
    if (mode == "ir_se") != has_se:
        raise ValueError(
            f"mode={mode!r} does not match the params tree (which "
            f"{'has' if has_se else 'lacks'} SE blocks)")
    out: SD = {}
    _conv(out, "input_layer.0", params["input"]["conv"])
    _bn(out, "input_layer.1", params["input"]["bn"], state["input"]["bn"])
    out["input_layer.2.weight"] = _t(params["input"]["prelu"]["slope"])
    for i, (in_ch, depth, _) in enumerate(units):
        up, us = params["body"][i], state["body"][i]
        if in_ch != depth:
            _conv(out, f"body.{i}.shortcut_layer.0", up["shortcut"]["conv"])
            _bn(out, f"body.{i}.shortcut_layer.1", up["shortcut"]["bn"],
                us["shortcut"]["bn"])
        r, rs = up["res"], us["res"]
        _bn(out, f"body.{i}.res_layer.0", r["bn1"], rs["bn1"])
        _conv(out, f"body.{i}.res_layer.1", r["conv1"])
        out[f"body.{i}.res_layer.2.weight"] = _t(r["prelu"]["slope"])
        _conv(out, f"body.{i}.res_layer.3", r["conv2"])
        _bn(out, f"body.{i}.res_layer.4", r["bn2"], rs["bn2"])
        if mode == "ir_se":
            for fc in ("fc1", "fc2"):
                out[f"body.{i}.res_layer.5.{fc}.weight"] = _t(
                    np.asarray(r["se"][fc]["w"])[:, :, None, None])
    _bn(out, "bn", params["bn"], state["bn"])
    _bn(out, "output_layer.0", params["output"]["bn2d"], state["output"]["bn2d"])
    out["output_layer.3.weight"] = _t(params["output"]["linear"]["w"])
    out["output_layer.3.bias"] = _t(params["output"]["linear"]["b"])
    _bn(out, "output_layer.4", params["output"]["bn1d"], state["output"]["bn1d"])
    return out


def _conv_layer(out: SD, prefix: str, params, state) -> None:
    _conv(out, f"{prefix}.conv2d", params["conv"])
    if params["norm"]:
        if state is None or "mean" in state["norm"]:
            _bn(out, f"{prefix}.norm.norm", params["norm"],
                None if state is None else state["norm"])
        else:  # in / gn / layer: affine only
            out[f"{prefix}.norm.norm.weight"] = _t(params["norm"]["scale"])
            out[f"{prefix}.norm.norm.bias"] = _t(params["norm"]["bias"])
    if "slope" in params["relu"]:
        out[f"{prefix}.relu.func.weight"] = _t(params["relu"]["slope"])


def _res_block(out: SD, prefix: str, params, state) -> None:
    for k in ("conv1", "conv2"):
        _conv_layer(out, f"{prefix}.{k}", params[k], None if state is None else state[k])


def recnet_state_dict(params, state=None) -> SD:
    """RecNet tree -> RecNet state dict; with state None, the parameters
    alone (a tree shaped like params: an optimizer's moments)."""
    out: SD = {}

    def sub(*keys):
        return None if state is None else _get(state, keys)

    sp, ss = params["conv4space"], sub("conv4space")
    for name, idx in [("c0", 0), ("r0", 1), ("c1", 2), ("r1", 3), ("c2", 4),
                      ("r2", 5)]:
        add = _conv_layer if name.startswith("c") else _res_block
        add(out, f"Conv4Space.{idx}", sp[name], None if ss is None else ss[name])
    c4c = params["conv4channel"]
    for i, idx in enumerate([0, 2, 3, 5, 6, 8]):
        out[f"Conv4Channel.{idx}.weight"] = _t(c4c[f"lin{i}"]["w"])
        out[f"Conv4Channel.{idx}.bias"] = _t(c4c[f"lin{i}"]["b"])
    for i, idx in enumerate([1, 4, 7]):
        out[f"Conv4Channel.{idx}.func.weight"] = _t(c4c[f"prelu{i}"]["slope"])
    for key, name in (("flipmerge", "ChannelFlipMerge"), ("merge", "Conv4Merge")):
        _conv_layer(out, f"{name}.0", params[key]["c"], sub(key, "c"))
        _res_block(out, f"{name}.1", params[key]["r"], sub(key, "r"))
    out["classifier.weight"] = _t(params["classifier"]["w"])
    return out


def _conv_block(out: SD, prefix: str, params, state) -> None:
    _conv(out, f"{prefix}.conv", params["conv"])
    _bn(out, f"{prefix}.bn", params["bn"], state["bn"])
    if "prelu" in params:
        out[f"{prefix}.prelu.weight"] = _t(params["prelu"]["slope"])


def _depthwise(out: SD, prefix: str, params, state) -> None:
    for k in ("conv", "conv_dw", "project"):
        _conv_block(out, f"{prefix}.{k}", params[k], state[k])


def mobilefacenet_state_dict(params, state) -> SD:
    """MobileFaceNet tree -> MobileFaceNet state dict (reference keys)."""
    out: SD = {}
    for name, kind, *_ in MOBILEFACENET_ARCH:
        if kind in ("conv", "linear"):
            _conv_block(out, name, params[name], state[name])
        elif kind == "dw":
            _depthwise(out, name, params[name], state[name])
        else:
            for i, (p, s) in enumerate(zip(params[name], state[name])):
                _depthwise(out, f"{name}.model.{i}", p, s)
    out["linear.weight"] = _t(params["linear"]["w"])
    _bn(out, "bn", params["bn"], state["bn"])
    return out


def hgblock_state_dict(params, state) -> SD:
    """init_hgblock's tree -> HGBlock state dict: each ConvLayer under its
    JAX name (`b1_2.conv2d.weight`, `out.conv2d.bias`, ...)."""
    out: SD = {}
    for name in params:
        _conv_layer(out, name, params[name], state[name])
    return out


def se_layer_state_dict(params) -> SD:
    """init_se_layer's tree -> SELayer state dict (`fc.0.weight`,
    `fc.2.weight`; both packages keep Linear's (out, in))."""
    return {"fc.0.weight": _t(params["fc1"]["w"]), "fc.2.weight": _t(params["fc2"]["w"])}


def head_state_dict(kernel) -> SD:
    """An Arcface / AmSoftmax kernel (embedding_size, classnum) -> the
    head's state dict, the layout unchanged."""
    return {"kernel": _t(kernel)}


def _get(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


# optimizer -> (the optax state's class name, {torch.optim name: its field})
_MOMENTS = {
    "adam": ("ScaleByAdamState", {"exp_avg": "mu", "exp_avg_sq": "nu"}),
    "sgd": ("TraceState", {"momentum_buffer": "trace"}),
    "rmsprop": ("RMSpropState", {"square_avg": "square_avg", "momentum_buffer": "momentum"}),
    "adabound": ("AdaBoundState", {"exp_avg": "exp_avg", "exp_avg_sq": "exp_avg_sq"}),
}
#: optimizer -> the names of its torch.optim per-parameter state
STATE_NAMES = {name: frozenset(fields) | {"step"} for name, (_, fields) in _MOMENTS.items()}


def _find_state(tree, cls_name):
    """The first node of an optax state tree (tuples of NamedTuples) whose
    class is `cls_name`, or None."""
    if type(tree).__name__ == cls_name:
        return tree
    if isinstance(tree, tuple):
        for sub in tree:
            found = _find_state(sub, cls_name)
            if found is not None:
                return found
    return None


def _torch_optimizer_state(name: str, trees: Dict[str, Any], step: int):
    """{torch.optim name: a params-shaped JAX tree} -> {RecNet parameter
    key: torch.optim state of that parameter}, with its step."""
    out: Dict[str, Dict[str, Any]] = {}
    for tname, tree in trees.items():
        for key, v in recnet_state_dict(tree).items():
            out.setdefault(key, {})[tname] = v
    for st in out.values():
        if name in ("adam", "rmsprop"):  # torch.optim keeps a float32 step tensor
            st["step"] = torch.tensor(float(step), dtype=torch.float32)
        elif name == "adabound":
            st["step"] = int(step)
    return out


def optimizer_state_dict(optimizer: str, opt_state, step: int) -> Dict[str, Dict[str, Any]]:
    """The optax state of `make_optimizer(optimizer, ...)` -> {RecNet
    parameter key: torch.optim state of that parameter}. `step` is the
    count of updates taken. SGD without momentum has no state ({})."""
    name = optimizer.lower()
    if name not in _MOMENTS:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    cls_name, fields = _MOMENTS[name]
    node = _find_state(opt_state, cls_name)
    if node is None:
        if name == "sgd":
            return {}
        raise ValueError(f"{optimizer}: no {cls_name} in the optimizer state")
    return _torch_optimizer_state(
        name, {tname: getattr(node, jname) for tname, jname in fields.items()}, step)


def _conv_layer_tree(sd, prefix: str):
    t = {"conv": {"w": _np(sd[f"{prefix}.conv2d.weight"]).transpose(2, 3, 1, 0)},
         "norm": {}, "relu": {}}
    if f"{prefix}.conv2d.bias" in sd:
        t["conv"]["b"] = _np(sd[f"{prefix}.conv2d.bias"])
    if f"{prefix}.norm.norm.weight" in sd:
        t["norm"] = {"scale": _np(sd[f"{prefix}.norm.norm.weight"]),
                     "bias": _np(sd[f"{prefix}.norm.norm.bias"])}
    if f"{prefix}.relu.func.weight" in sd:
        t["relu"] = {"slope": _np(sd[f"{prefix}.relu.func.weight"])}
    return t


def _res_block_tree(sd, prefix: str):
    return {k: _conv_layer_tree(sd, f"{prefix}.{k}") for k in ("conv1", "conv2")}


def recnet_param_tree(sd) -> Dict[str, Any]:
    """A RecNet state dict -> the JAX package's params tree (numpy, its
    layouts): the inverse of `recnet_state_dict` on the parameters."""
    space = {}
    for name, idx in [("c0", 0), ("r0", 1), ("c1", 2), ("r1", 3), ("c2", 4), ("r2", 5)]:
        build = _conv_layer_tree if name.startswith("c") else _res_block_tree
        space[name] = build(sd, f"Conv4Space.{idx}")
    chan = {}
    for i, idx in enumerate([0, 2, 3, 5, 6, 8]):
        chan[f"lin{i}"] = {"w": _np(sd[f"Conv4Channel.{idx}.weight"]),
                           "b": _np(sd[f"Conv4Channel.{idx}.bias"])}
    for i, idx in enumerate([1, 4, 7]):
        chan[f"prelu{i}"] = {"slope": _np(sd[f"Conv4Channel.{idx}.func.weight"])}
    tree = {"conv4space": space, "conv4channel": chan,
            "classifier": {"w": _np(sd["classifier.weight"])}}
    for key, name in (("flipmerge", "ChannelFlipMerge"), ("merge", "Conv4Merge")):
        tree[key] = {"c": _conv_layer_tree(sd, f"{name}.0"),
                     "r": _res_block_tree(sd, f"{name}.1")}
    return tree


def _leaf_paths(tree, prefix=()):
    """The (path, leaf) pairs of a nested dict in jax.tree.leaves order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(_leaf_paths(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def _set_path(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


# optimizer -> the segments of its flat optax leaves, in order: 'count' is
# one scalar (the update count), '-' a params-shaped tree of scalars that
# torch.optim has no counterpart of (AdaBound's unused max_exp_avg_sq),
# any other name a params-shaped tree of that torch.optim state
_OPTAX_LEAVES = {
    "adam": ("count", "exp_avg", "exp_avg_sq", "count"),
    "sgd": ("momentum_buffer", "count"),
    "rmsprop": ("square_avg", "momentum_buffer", "count"),
    "adabound": ("count", "exp_avg", "exp_avg_sq", "-"),
}


def optimizer_state_from_leaves(optimizer: str, leaves, recnet_sd, step: int):
    """The flat optax leaves of a JAX checkpoint (`optimizer_tpu`) ->
    {RecNet parameter key: torch.optim state}, as `optimizer_state_dict`
    gives them from the optax state itself. recnet_sd: the state dict of
    the RecNet they belong to (it gives the tree and every leaf's shape).
    Raises ValueError on a leaf count or a leaf shape that does not fit."""
    name = optimizer.lower()
    if name not in _OPTAX_LEAVES:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    skeleton = recnet_param_tree(recnet_sd)
    paths = _leaf_paths(skeleton)
    layout = _OPTAX_LEAVES[name]
    if name == "sgd" and len(leaves) == 1:  # no momentum: the count alone
        layout = ("count",)
    n = sum(1 if seg == "count" else len(paths) for seg in layout)
    if len(leaves) != n:
        raise ValueError(f"optimizer state mismatch: {n} leaves expected for {name}, "
                         f"checkpoint has {len(leaves)} (different optimizer?)")
    trees, i = {}, 0
    for seg in layout:
        if seg == "count":
            i += 1
            continue
        if seg != "-":
            tree = recnet_param_tree(recnet_sd)
            for j, (path, ref) in enumerate(paths):
                leaf = _np(leaves[i + j])
                if leaf.shape != ref.shape:
                    raise ValueError(
                        f"optimizer state mismatch at leaf {i + j} ({seg} of "
                        f"{'/'.join(path)}): checkpoint shape {leaf.shape} vs expected "
                        f"{ref.shape} (different model configuration?)")
                _set_path(tree, path, leaf.astype(ref.dtype))
            trees[seg] = tree
        i += len(paths)
    return _torch_optimizer_state(name, trees, step)


def train_state_dicts(params, model_state, opt_state, step, optimizer: str):
    """A JAX TrainState's trees -> (RecNet state dict, the optimizer's
    per-parameter state, the update count) for
    `ffrnet_torch.training.trainer.load_train_state`."""
    step = int(np.asarray(step))
    return (recnet_state_dict(params, model_state),
            optimizer_state_dict(optimizer, opt_state, step), step)
