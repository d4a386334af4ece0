"""Traffic kind `train`: `ffrnet_torch.training.trainer.train_step`, step
after step, on a frozen IR-SE50 (`build_backbone`) and RecNet in train
mode (`create_train_state`), holding the weights the benchmark draws on
the card (the encoder from the seed, RecNet from seed + 1;
`benchmarks/reference/weights.py`). Each step uploads one batch of a pool
held in pinned host memory: uint8 faces drawn from the seed, their masked
twins (the occluder region of `tools/synth.py::occlude` set to 0, which is
-1 after normalization) and labels uniform over the classes.

Parameters (the traffic file): batch, pool, dtype, mask (rows, cols),
trace_calls, and `trainer`, the optimizer and objective settings (the
training driver's defaults, written out): the program's TrainerConfig and
the reference both take them from there, so a change of the program's
defaults does not change the cell. Set-up takes the first `checked_steps`
steps through the window's own call and feed, and keeps what they left:
each step's loss, Adam's first moment after step 1 and the parameters
after the last. Once the window has closed, one more step through the same
call and feed, from the state the window left, keeps that state, the
step's loss and the parameters and both Adam moments after it.

Correctness (`benchmarks/reference/train.py`): from the same seed the
reference follows the checked steps: `loss1_gap`, the relative gap of the
first step's loss, and `loss_gap`, the largest of every checked step's;
`grad_gap`, the worst leaf's gap between the norms of the first gradient
as Adam gets it (clipped, plus the weight decay); `change_gap`, the worst
leaf's gap between the norms of the parameters' change over the steps.
From the state the window left (the program's: the reference cannot
replay hundreds of steps in less than the window) it takes the step after
the window: `window_loss_gap`, the relative gap of that step's loss, and
`window_state_gap`, the worst leaf's gap between the norms of the
parameters' change in that step, of Adam's first moment and of its second
moment after it. A leaf's gap is measured against the larger of the
reference's norm of that leaf and of the median leaf; leaves whose clipped
reference gradient is under a thousandth of the median leaf's are left out
of the changes.
"""

from __future__ import annotations

import statistics
import sys

import torch

from benchmarks.flops import train_step_flops
from benchmarks.reference import irse, recnet
from benchmarks.reference.numerics import Numerics, tf32
from benchmarks.reference.serve import unit_range
from benchmarks.reference.train import Trainer
from benchmarks.system import (ITEMSIZE, STREAM_LABELS, STREAM_TRAFFIC, DriverBase, encoder,
                               loaded, recnet_config, recnet_weights, stream, uint8_images)


def _host(tensors: dict, dtype=torch.float64) -> dict:
    return {k: v.detach().to("cpu", dtype, copy=True) for k, v in tensors.items()}


def trainer_config(traffic: dict, config: dict):
    """The program's TrainerConfig from the traffic file's `trainer`."""
    from ffrnet_torch.training.trainer import TrainerConfig

    t = traffic["trainer"]
    if t["optimizer"] != "adam" or not t["faithful_ce_weight"] or traffic["dtype"] != "fp32":
        raise SystemExit("benchmark: the train kind's reference is the fp32 Adam step with "
                         "the reference's cross-entropy weighting")
    return TrainerConfig(optimizer="adam", lr=t["lr"], beta1=t["beta1"], beta2=t["beta2"],
                         weight_decay=t["weight_decay"], loss_weight=tuple(t["loss_weight"]),
                         milestones=tuple(t["milestones"]), lr_gamma=t["lr_gamma"],
                         clip_value=t["clip_value"], faithful_ce_weight=True,
                         ss_loss_impl=t["ss_loss_impl"], compute_dtype="fp32",
                         remat=t["remat"], recnet=recnet_config(config))


def worst(got: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the norms of `got` and `ref`, against
    the larger of the reference leaf's norm and the median leaf's."""
    norms = {k: float(v.norm()) for k, v in ref.items()}
    floor = statistics.median(norms.values())
    keys = [k for k in ref if keep is None or k in keep]
    return max(abs(float(got[k].double().norm()) - norms[k]) / max(norms[k], floor, 1e-30)
               for k in keys)


def moved(raw_grad: dict) -> set:
    """The leaves whose clipped reference gradient is at least a thousandth
    of the median leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(v.norm()) for k, v in raw_grad.items()}
    med = statistics.median(norms.values())
    keep = {k for k, v in norms.items() if v >= 1e-3 * med}
    if len(keep) < len(norms):
        print(f"[benchmark] the changes leave out {sorted(set(norms) - keep)}", file=sys.stderr)
    return keep


class Driver(DriverBase):
    program_state = ("encoder", "state")

    def __init__(self, run):
        super().__init__(run)
        from ffrnet_torch.training.trainer import create_train_state, train_step

        tr, cfg = self.traffic, self.spec.config
        self.batch, self.pool_n = tr["batch"], tr["pool"]
        self.cfg = trainer_config(tr, cfg)
        self.train_step = train_step
        seed = run.seed
        self.encoder = encoder(cfg, seed, self.dev)
        self.state = create_train_state(self.cfg, seed=seed + 1, device=self.dev)
        loaded(self.state.model, recnet_weights(cfg, seed, self.dev))
        self.make_pool()
        run.info.update(batch=self.batch, itemsize=ITEMSIZE[tr["dtype"]], compute="fp32",
                        flops_per_call=train_step_flops(self.batch,
                                                        cfg["recnet"]["num_classes"]))
        self.offset = 0
        named = dict(self.state.model.named_parameters())
        self.p0 = _host(named)
        self.losses = []
        for i in range(tr["checked_steps"]):
            self.call(i)
            self.losses.append(self.metrics["TotalLoss"])
            if i == 0:
                inner = self.state.optimizer.inner.state
                self.m1 = _host({k: inner[p]["exp_avg"] for k, p in named.items()})
        self.p_last = _host(named)
        self.losses = [float(x) for x in self.losses]
        for i in range(tr["checked_steps"], tr["warm_steps"]):
            self.call(i)
        self.offset = tr["warm_steps"]

    def make_pool(self):
        tr, n, b = self.traffic, self.pool_n, self.batch
        faces = uint8_images((n, b, 112, 112, 3), self.run.seed, STREAM_TRAFFIC, self.dev)
        masked = faces.clone()
        (r0, r1), (c0, c1) = tr["mask"]
        masked[:, :, r0:r1, c0:c1, :] = 0
        g = torch.Generator(device=self.dev).manual_seed(stream(self.run.seed, STREAM_LABELS))
        labels = torch.randint(0, self.spec.config["recnet"]["num_classes"], (n, b),
                               generator=g, device=self.dev)
        self.pool = [{"img_non": faces[k].cpu(), "img_ocl": masked[k].cpu(),
                      "label": labels[k].cpu()} for k in range(n)]
        if self.dev.type == "cuda":  # page-locked, as the driver's loader holds them
            self.pool = [{key: t.pin_memory() for key, t in batch.items()}
                         for batch in self.pool]

    def after_window(self):
        """One more step through the window's call and feed, from the state
        the window left; keeps that state (on the host), the step's batch
        and loss, and the parameters and both moments after it."""
        named = dict(self.state.model.named_parameters())
        inner = self.state.optimizer.inner.state

        def snapshot():
            f32 = torch.float32
            return (_host(named, f32),
                    _host({k: inner[p]["exp_avg"] for k, p in named.items()}, f32),
                    _host({k: inner[p]["exp_avg_sq"] for k, p in named.items()}, f32))

        buffers = {k: v for k, v in self.state.model.named_buffers()
                   if not k.endswith("num_batches_tracked")}
        self.w_before = snapshot() + (_host(buffers, torch.float32), self.state.step)
        i = self.run.window.calls
        self.w_batch = (i + self.offset) % self.pool_n
        self.call(i)
        self.w_loss = float(self.metrics["TotalLoss"])
        self.w_after = snapshot()

    def call(self, i):
        k = (i + self.offset) % self.pool_n
        with self.span("upload"):
            batch = {key: t.to(self.dev, non_blocking=True) for key, t in self.pool[k].items()}
        with self.span("step"):
            self.state, self.metrics = self.train_step(self.encoder, self.state, batch,
                                                       cfg=self.cfg)
        return self.batch

    # ------------------------------------------------------- correctness
    def hyper(self):
        t, r = self.traffic["trainer"], self.spec.config["recnet"]
        return {"lr": t["lr"], "betas": (t["beta1"], t["beta2"]), "eps": t["eps"],
                "weight_decay": t["weight_decay"], "clip": t["clip_value"],
                "loss_weight": tuple(t["loss_weight"]), "milestones": t["milestones"],
                "lr_gamma": t["lr_gamma"], "s": r["s"], "m": r["m"]}

    def _x(self, b, key, sl):
        u = b[key][sl].to(self.dev)
        return unit_range(u).permute(0, 3, 1, 2).contiguous()

    def _encoder(self):
        return irse.init_params(self.run.seed, self.dev)

    def reference_answers(self, precision="fp32", rows=None):
        """The reference's (losses, first gradient, change, clipped first
        gradient) over the checked steps, from the seed. precision "tf32" is
        the control; `rows` keeps only the first rows of each batch (the
        half-batch fault)."""
        rec = recnet.init_params(self.run.seed + 1, self.spec.config["recnet"]["num_classes"],
                                 self.dev)
        tr = Trainer(self._encoder(), rec, self.hyper())
        start = {k: v.clone() for k, v in tr.params.items()}
        num = Numerics()
        sl = slice(None) if rows is None else slice(0, rows)
        with tf32(precision == "tf32"):
            for i in range(self.traffic["checked_steps"]):
                b = self.pool[i % self.pool_n]
                tr.step(self._x(b, "img_non", sl), self._x(b, "img_ocl", sl),
                        b["label"][sl].to(self.dev), num)
        change = {k: (tr.params[k] - start[k]).double().cpu() for k in start}
        grad = {k: v.double().cpu() for k, v in tr.first_grad.items()}
        raw = {k: v.double().cpu() for k, v in tr.first_grad_raw.items()}
        return tr.losses, grad, change, raw

    def reference_window(self, precision="fp32", rows=None):
        """The reference's (loss, change, first moment, second moment,
        clipped gradient) of the step after the window, from the state the
        window left."""
        params, m, v, buffers, count = self.w_before

        def dev(d):
            return {k: t.to(self.dev, torch.float32) for k, t in d.items()}

        tr = Trainer(self._encoder(), {**dev(params), **dev(buffers)}, self.hyper(),
                     moments=(dev(m), dev(v)), count=count)
        start = {k: t.clone() for k, t in tr.params.items()}
        b = self.pool[self.w_batch]
        sl = slice(None) if rows is None else slice(0, rows)
        with tf32(precision == "tf32"):
            loss = tr.step(self._x(b, "img_non", sl), self._x(b, "img_ocl", sl),
                           b["label"][sl].to(self.dev), Numerics())

        def host(d):
            return {k: t.double().cpu() for k, t in d.items()}

        change = {k: tr.params[k] - start[k] for k in start}
        return loss, host(change), host(tr.m), host(tr.v), host(tr.first_grad_raw)

    def program_answers(self):
        b1 = self.traffic["trainer"]["beta1"]
        grad = {k: v / (1 - b1) for k, v in self.m1.items()}
        change = {k: self.p_last[k] - self.p0[k] for k in self.p0}
        params, m, v = self.w_after
        w_change = {k: params[k].double() - self.w_before[0][k].double() for k in params}
        return self.losses, grad, change, (self.w_loss, w_change, m, v)

    @staticmethod
    def compare(answers, want, w_want):
        losses, grad, change, (w_loss, w_change, w_m, w_v) = answers
        r_losses, r_grad, r_change, r_raw = want
        r_wloss, r_wchange, r_wm, r_wv, r_wraw = w_want
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, r_losses)]
        return {"loss1_gap": gaps[0], "loss_gap": max(gaps),
                "grad_gap": worst(grad, r_grad),
                "change_gap": worst(change, r_change, moved(r_raw)),
                "window_loss_gap": abs(w_loss - r_wloss) / abs(r_wloss),
                "window_state_gap": max(worst(w_change, r_wchange, moved(r_wraw)),
                                        worst(w_m, r_wm), worst(w_v, r_wv))}

    def controls(self):
        """The readings of the control (the reference in TF32) and of the
        faults a one-chip training step can have: half of each batch left
        out (the mean over the rest), and a step that leaves the state
        unchanged (the first loss at every step, no change, the moments as
        they were)."""
        want, w_want = self.reference_answers(), self.reference_window()

        def as_answers(ref, w_ref):
            return ref[0], ref[1], ref[2], w_ref[:4]

        control = self.spec.workload["control"]
        half = self.batch // 2
        zero = {k: torch.zeros_like(v) for k, v in want[2].items()}
        _, m, v, _, _ = self.w_before
        unchanged = ([want[0][0]] * len(want[0]), want[1], zero,
                     (w_want[0], {k: torch.zeros_like(t) for k, t in w_want[1].items()}, m, v))
        return {"control": self.compare(as_answers(self.reference_answers(control),
                                                   self.reference_window(control)),
                                        want, w_want),
                "half_batch": self.compare(as_answers(self.reference_answers(rows=half),
                                                      self.reference_window(rows=half)),
                                           want, w_want),
                "state_unchanged": self.compare(unchanged, want, w_want)}

    def check(self):
        numbers = self.compare(self.program_answers(), self.reference_answers(),
                               self.reference_window())
        lim = self.spec.workload["limits"]
        failed = int(any(numbers[k] > lim[k] for k in lim))
        return numbers, failed
