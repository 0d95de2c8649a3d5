"""Driver of GCMC alone on MovieLens-10M-shaped ratings: one model, through
the port's scale training entry.

Set-up makes the ratings on the card from the seed
(``gnnbench/inputs/movielens.py``), builds the port's inputs with
``train.scale.build_gcmc_inputs`` (the slabbed encoder graphs of 10
relations a direction and the bilinear decoder's layouts), hands the
harness's weights and generator to ``train.step.init_state``, and steps
with ``make_one_step`` through ``run_steps``; the eval is
``train.step.evaluate`` (the expected rating's RMSE) on the valid and the
test ratings, as ``train.loop.train_on_inputs`` runs them.  The plain
reference is ``gnnbench/reference/gcmc.py``.

Controls (``reference(control)``): ``tf32``, the reference with TF32 on;
``bf16``, its messages and the decoder's reads rounded to bf16.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from gnnbench import counts_gcmc, seeds
from gnnbench.drivers.stacked import precision
from gnnbench.harness import sync
from gnnbench.inputs import params as P
from gnnbench.inputs.movielens import ratings

DECODER_KERNELS = r"\b(bilinear_\w+|task_sum)_kernel"
CONTROLS = ("tf32", "bf16")


def param_spec(cfg: dict):
    """[(path, shape, bound)] of one model: DGL's initialisers' bounds
    (xavier for the relation weights, the Linear weights and the basis,
    nn.Linear's U(+-1/sqrt(fan_in)) for the biases)."""
    r, units, d = cfg["num_ratings"], cfg["gcn_agg_units"], \
        cfg["gcn_out_units"]
    msg, b = units // r, cfg["gen_r_num_basis_func"]
    x = lambda a, c: math.sqrt(6.0 / (a + c))  # noqa: E731
    return [
        (("tgcn", 0, "w_drug"), (r, cfg["n_users"], msg),
         x(cfg["n_users"], msg)),
        (("tgcn", 0, "w_dis"), (r, cfg["n_movies"], msg),
         x(cfg["n_movies"], msg)),
        (("tgcn", 0, "ifc_w"), (units, d), x(units, d)),
        (("tgcn", 0, "ifc_b"), (d,), 1.0 / math.sqrt(units)),
        (("tgcn", 0, "fc_w"), (units, d), x(units, d)),
        (("tgcn", 0, "fc_b"), (d,), 1.0 / math.sqrt(units)),
        (("decoder", "P"), (b, d, d), x(d, d)),
        (("decoder", "a"), (r, b), x(b, r)),
    ]


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from dream_gnn_tpu_torch.config import (AugmentConfig, ModelConfig,
                                                TrainConfig)
        from dream_gnn_tpu_torch.train.scale import build_gcmc_inputs
        from dream_gnn_tpu_torch.train.step import (evaluate, init_state,
                                                    make_one_step, run_steps)

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.n_models = 1
        nu, nm = cfg["n_users"], cfg["n_movies"]
        marks = [time.perf_counter()]
        self.raw = ratings(cfg, seeds.sub(seed, "data"), device)
        sync(device)
        marks.append(time.perf_counter())
        raw = self.raw
        (self.inputs, self.labels, self.weights,
         self.layout_build_s) = build_gcmc_inputs(
            raw["users"], raw["movies"], raw["levels"],
            (raw["train"], raw["valid"], raw["test"]), nu, nm, device,
            num_ratings=cfg["num_ratings"])
        sync(device)
        marks.append(time.perf_counter())
        keys = {f.name for f in dataclasses.fields(ModelConfig)}
        self.model_cfg = ModelConfig(
            **{k: v for k, v in cfg.items()
               if k in keys and k != "rating_values"},
            src_in_units=nu, dst_in_units=nm,
            rating_values=tuple(cfg["rating_values"]))
        train_cfg = TrainConfig(
            model=self.model_cfg, augment=AugmentConfig(methods=()),
            train_lr=cfg["train_lr"], weight_decay=cfg["weight_decay"],
            train_grad_clip=cfg["train_grad_clip"],
            train_valid_interval=cfg["train_valid_interval"], beta=0.0)
        self.param_seed = seeds.sub(seed, "params")
        self.draw_seed = seeds.sub(seed, "draws")
        self.spec = param_spec(cfg)
        params = P.one_model(P.make_params(self.spec, 1, self.param_seed,
                                          device))
        gen = torch.Generator(device=device).manual_seed(self.draw_seed)
        self.state = init_state(params, gen, train_cfg)
        self._one_step = make_one_step(self.model_cfg, train_cfg)
        self._run_steps, self._evaluate = run_steps, evaluate
        self.interval = cfg["train_valid_interval"]
        sync(device)
        marks.append(time.perf_counter())
        self.setup_parts = dict(zip(
            ("ratings", "builders", "state"),
            (b - a for a, b in zip(marks, marks[1:]))))
        lv = raw["levels"][raw["train"]]
        self.edges = torch.bincount(lv, minlength=cfg["num_ratings"]).tolist()

    def step(self, n: int) -> torch.Tensor:
        return self._run_steps(self._one_step, self.state, n, self.inputs[0],
                               self.labels[0], self.weights[0])

    def evaluate(self):
        """(1, 2, 1) the valid and the test RMSE."""
        return torch.stack([self._evaluate(
            self.state.params, self.inputs[k], self.model_cfg,
            self.labels[k], self.weights[k])[0] for k in (1, 2)])[
            None, :, None].double().cpu().numpy()

    def warm_up(self) -> dict:
        leaves = [t for _, t in P.leaves(self.state.params)]
        out = {"loss": []}
        for i in range(self.traffic["compare_steps"]):
            out["loss"].append(self.step(1).double().cpu())
            if i == 0:
                opt = self.state.opt.state
                # An optimizer that did not step keeps no moments.
                out["grad"] = torch.stack([
                    torch.linalg.vector_norm(opt[t]["exp_avg"]) / 0.1
                    if "exp_avg" in opt[t]
                    else torch.zeros((), device=t.device)
                    for t in leaves])[:, None].double().cpu()
        out["loss"] = torch.stack(out["loss"]).numpy()
        out["draws"] = self.state.generator.get_state().numpy()
        start = P.one_model(P.make_params(self.spec, 1, self.param_seed,
                                         self.device))
        out["change"] = torch.stack([
            torch.linalg.vector_norm(t.detach() - s)
            for t, (_, s) in zip(leaves, P.leaves(start))])[
            :, None].double().cpu()
        out["eval"] = self.evaluate()
        return out

    def release(self):
        self.state = self.inputs = self.labels = self.weights = None
        self._one_step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control: str | None = None) -> dict:
        from gnnbench.reference import gcmc

        if control not in (None, *CONTROLS):
            raise ValueError(f"no control {control!r} here: {CONTROLS}")
        params = P.one_model(P.make_params(self.spec, 1, self.param_seed,
                                          self.device))
        with precision(control == "tf32"):
            return gcmc.run(self.raw, self.cfg, params, self.draw_seed,
                            self.device, steps=self.traffic["compare_steps"],
                            dtype=torch.bfloat16 if control == "bf16"
                            else torch.float32)

    def counts(self) -> dict:
        cfg = self.cfg
        nu, nm, r = cfg["n_users"], cfg["n_movies"], cfg["num_ratings"]
        d, b = cfg["gcn_out_units"], cfg["gen_r_num_basis_func"]
        msg = cfg["gcn_agg_units"] // r
        n_train = float(sum(self.edges))
        least = counts_gcmc.bilinear_least_s(n_train, nu, nm, r, b, d)
        seg = sum(2 * (counts_gcmc.segment_sum_bytes(nu, nm, e, msg)
                       + counts_gcmc.segment_sum_bytes(nm, nu, e, msg))
                  for e in self.edges)
        return dict(step_ops=counts_gcmc.step_ops(cfg, self.edges, n_train),
                    decoder_least_s=least, bilinear_least_s=least,
                    decoder_kernels=DECODER_KERNELS, segment_sum_bytes=seg)


def build(cfg: dict, traffic: dict, seed: int, device) -> Run:
    return Run(cfg, traffic, seed, device)

