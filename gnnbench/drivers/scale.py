"""Driver of the scale path's cell: one model on the planted 100k x 100k
problem, through the port's single-device scale training entry.

Set-up makes the problem on the card from the seed, builds the port's
inputs with ``train.scale.build_inputs`` (the slabbed encoder graph, the
identity similarity graphs and the scale decoder's layouts), hands the
harness's weights and generator to ``train.step.init_state``, and steps
with ``make_one_step`` through ``run_steps``; the eval is
``train.step.evaluate`` on the train and the test candidates, as
``train.loop.train_on_inputs`` runs them.
"""

from __future__ import annotations

import time

import torch

from gnnbench import counts, seeds
from gnnbench.harness import sync
from gnnbench.drivers.stacked import bf16_points, port_configs, precision
from gnnbench.inputs import params as P
from gnnbench.inputs.planted import planted_problem

DECODER_KERNELS = r"\bscale_(fwd|bwd)(_mma)?_kernel"


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from dream_gnn_tpu_torch.train.scale import build_inputs
        from dream_gnn_tpu_torch.train.step import (evaluate, init_state,
                                                    make_one_step, run_steps)

        self.cfg, self.traffic, self.device = cfg, traffic, device
        nd, nv, d = cfg["n_drug"], cfg["n_dis"], cfg["d"]
        self.n_models = 1
        marks = [time.perf_counter()]
        self.prob = planted_problem(nd, nv, cfg["rank"], d, cfg["n_enc"],
                                    cfg["n_cand"], cfg["pos_rate"],
                                    seeds.sub(seed, "data"), device)
        sync(device)
        marks.append(time.perf_counter())
        # The port's builder takes the problem as host arrays.
        host = {k: tuple(x.cpu().numpy() for x in self.prob[k])
                for k in ("enc", "train", "test")}
        host.update(feat_drug=self.prob["feat_drug"].cpu().numpy(),
                    feat_dis=self.prob["feat_dis"].cpu().numpy())
        sync(device)
        t0 = time.perf_counter()
        marks.append(t0)
        (self.train_in, self.test_in, lab_tr, lab_te, w_tr, w_te,
         _) = build_inputs(host, nd, nv, device)
        sync(device)
        self.layout_build_s = time.perf_counter() - t0
        marks.append(time.perf_counter())
        self.sides = ((self.train_in, lab_tr, w_tr),
                      (self.test_in, lab_te, w_te))

        self.model_cfg, train_cfg = port_configs(
            cfg, src_in_units=d, dst_in_units=d, fdim_drug=d,
            fdim_disease=d)
        self.param_seed = seeds.sub(seed, "params")
        self.draw_seed = seeds.sub(seed, "draws")
        self.spec = P.param_spec(cfg, d, d, d)
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
            ("problem", "host copy", "builders", "state"),
            (b - a for a, b in zip(marks, marks[1:]))))
        y = self.prob["enc"][2].long()
        self.edges = [int((y == r).sum()) for r in range(cfg["num_ratings"])]

    def step(self, n: int) -> torch.Tensor:
        inputs, labels, weight = self.sides[0]
        return self._run_steps(self._one_step, self.state, n, inputs, labels,
                               weight)

    def evaluate(self):
        return torch.stack([torch.stack(self._evaluate(
            self.state.params, inputs, self.model_cfg, labels, weight))
            for inputs, labels, weight in self.sides])[None].cpu().numpy()

    def warm_up(self) -> dict:
        leaves = [t for _, t in P.leaves(self.state.params)]
        out = {"loss": []}
        for i in range(self.traffic["compare_steps"]):
            out["loss"].append(self.step(1).double().cpu())
            if i == 0:
                opt = self.state.opt.state
                # Adam keeps no state for a leaf that takes no gradient
                # (the FGCN's fusion, without feature graphs).
                out["grad"] = torch.stack([
                    torch.linalg.vector_norm(opt[t]["exp_avg"]) / 0.1
                    if "exp_avg" in opt[t]
                    else torch.zeros((), device=t.device)
                    for t in leaves])[:, None].cpu()
        out["loss"] = torch.stack(out["loss"]).numpy()
        out["draws"] = self.state.generator.get_state().numpy()
        start = P.one_model(P.make_params(self.spec, 1, self.param_seed,
                                         self.device))
        out["change"] = torch.stack([
            torch.linalg.vector_norm(t.detach() - s)
            for t, (_, s) in zip(leaves, P.leaves(start))])[:, None].cpu()
        out["eval"] = self.evaluate()
        return out

    def release(self):
        self.state = self.sides = self.train_in = self.test_in = None
        self._one_step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control: str | None = None) -> dict:
        from gnnbench.reference import sparse

        with precision(control == "tf32"):
            return sparse.run(self.prob, self.cfg, self.traffic, self.spec,
                              self.param_seed, self.draw_seed, self.device,
                              steps=self.traffic["compare_steps"],
                              dec_dtype=bf16_points(control))

    def counts(self) -> dict:
        cfg = self.cfg
        nd, nv, d, c = cfg["n_drug"], cfg["n_dis"], cfg["d"], cfg["n_cand"]
        ops = counts.sparse_step(cfg, nd, nv, self.edges, c, d)
        dec_ops, dec_bytes = counts.decoder_work(cfg, nd, nv, c, True)
        seg = 0.0
        for i in range(cfg["layers"]):
            msg = cfg["gcn_agg_units"] // 3 if i == 0 else cfg["gcn_out_units"]
            for e in self.edges:
                # Both directions, each forward and its transposed backward.
                seg += 2 * (counts.segment_sum_bytes(nd, nv, e, msg)
                            + counts.segment_sum_bytes(nv, nd, e, msg))
        h1 = cfg["decoder_hidden1"]
        seg += counts.segment_sum_bytes(c, nd, c, h1, gathered=False)
        seg += counts.segment_sum_bytes(c, nv, c, h1, gathered=False)
        return dict(step_ops=ops,
                    decoder_least_s=counts.least_seconds(dec_ops, dec_bytes),
                    decoder_kernels=DECODER_KERNELS, segment_sum_bytes=seg)


def build(cfg: dict, traffic: dict, seed: int, device) -> Run:
    return Run(cfg, traffic, seed, device)
