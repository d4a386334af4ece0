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
JAX takes the same next update in the port.

The module takes plain numpy trees and imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ffrnet_torch.models.irse import unit_configs

SD = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable copy


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
    out: Dict[str, Dict[str, Any]] = {}
    for tname, jname in fields.items():
        for key, v in recnet_state_dict(getattr(node, jname)).items():
            out.setdefault(key, {})[tname] = v
    for st in out.values():
        if name in ("adam", "rmsprop"):  # torch.optim keeps a float32 step tensor
            st["step"] = torch.tensor(float(step), dtype=torch.float32)
        elif name == "adabound":
            st["step"] = int(step)
    return out


def train_state_dicts(params, model_state, opt_state, step, optimizer: str):
    """A JAX TrainState's trees -> (RecNet state dict, the optimizer's
    per-parameter state, the update count) for
    `ffrnet_torch.training.trainer.load_train_state`."""
    step = int(np.asarray(step))
    return (recnet_state_dict(params, model_state),
            optimizer_state_dict(optimizer, opt_state, step), step)
