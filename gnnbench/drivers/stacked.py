"""Driver of the Gdataset protocol cells: a stack of seeds x folds models
trained as one, through the port's fold-parallel training entry.

Set-up makes the raw arrays from the seed, builds the port's dataset and
fold stacks with its own builders (``data.loader.DreamDataset``,
``sharding.foldstack.stack_folds`` and ``tile``), hands the harness's
weights and generator to ``train.stacked.init_state_stacked``, and steps
with ``make_one_step_stacked`` through ``train.step.run_steps``; the eval
is ``train.stacked.evaluate_stacked`` on the train stack and on the test
stack, as ``train_stacked_protocol`` runs them.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from gnnbench import counts, seeds
from gnnbench.harness import sync
from gnnbench.inputs import params as P
from gnnbench.inputs.synthetic import raw_arrays

DECODER_KERNELS = {
    "grid": r"\bgrid_(fwd|bwd)(_mma)?_kernel",
    "edges": r"\bedge_(fwd|bwd|scatter)(_mma)?_kernel",
}


def port_configs(cfg: dict, **model_fields):
    """The port's ``ModelConfig`` and ``TrainConfig`` of a configuration
    file, with the model fields that the cell or its data fix."""
    from dream_gnn_tpu_torch.config import AugmentConfig, ModelConfig, \
        TrainConfig

    keys = {f.name for f in dataclasses.fields(ModelConfig)}
    model = ModelConfig(**{k: v for k, v in cfg.items() if k in keys},
                        **model_fields)
    aug = cfg["aug"]
    augment = AugmentConfig(methods=tuple(aug["methods"]), **{
        k: v for k, v in aug.items() if k != "methods"})
    step = ("train_lr", "weight_decay", "train_grad_clip",
            "train_valid_interval", "beta", "label_smoothing")
    return model, TrainConfig(model=model, augment=augment,
                              **{k: cfg[k] for k in step})


class Run:
    """One cell's program, its inputs and its readings."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from dream_gnn_tpu_torch.data.loader import DreamDataset
        from dream_gnn_tpu_torch.data.synthetic import RawData
        from dream_gnn_tpu_torch.sharding.foldstack import stack_folds, tile
        from dream_gnn_tpu_torch.train.stacked import (evaluate_stacked,
                                                       init_state_stacked,
                                                       make_one_step_stacked)
        from dream_gnn_tpu_torch.train.step import run_steps

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.mode = traffic["decode_mode"]
        self.raw = raw_arrays(cfg["n_drug"], cfg["n_dis"], cfg["n_pos"],
                              cfg["embed_dim"], cfg["latent_dim"],
                              seeds.sub(seed, "data"))
        self.param_seed = seeds.sub(seed, "params")
        self.draw_seed = seeds.sub(seed, "draws")
        n_seeds, folds = traffic["n_seeds"], list(range(cfg["n_folds"]))
        self.n_models = n_seeds * len(folds)

        sync(device)
        t0 = time.perf_counter()
        dataset = DreamDataset(RawData(**self.raw), k=cfg["num_neighbor"],
                               symm=cfg["gcn_agg_norm_symm"],
                               n_folds=cfg["n_folds"],
                               kfold_seed=cfg["kfold_seed"], device=device)
        self.train = tile(stack_folds(dataset, folds, side="train"), n_seeds)
        self.test = tile(stack_folds(dataset, folds, side="test"), n_seeds)
        sync(device)
        self.layout_build_s = time.perf_counter() - t0

        self.nd, self.nv = dataset.n_drug, dataset.n_dis
        self.model_cfg, train_cfg = port_configs(
            cfg, decode_mode=self.mode, src_in_units=cfg["embed_dim"],
            dst_in_units=cfg["embed_dim"], fdim_drug=self.nd,
            fdim_disease=self.nv)
        self.spec = P.param_spec(cfg, self.nd, self.nv, cfg["embed_dim"])
        params = P.make_params(self.spec, self.n_models, self.param_seed,
                               device)
        gen = torch.Generator(device=device).manual_seed(self.draw_seed)
        self.state = init_state_stacked(params, gen, train_cfg)
        self._one_step = make_one_step_stacked(self.model_cfg, train_cfg)
        self._run_steps, self._evaluate = run_steps, evaluate_stacked
        self.interval = cfg["train_valid_interval"]

        # Cells of the decoder: the grid, or each fold's real candidates.
        w = self.train.edge_weight
        self.cells = float(self.nd * self.nv) if self.mode == "grid" \
            else float((w > 0).sum()) / self.n_models

    # -- the timed path ---------------------------------------------------
    def step(self, n: int) -> torch.Tensor:
        return self._run_steps(self._one_step, self.state, n,
                               self.train.inputs, self.train.labels,
                               self.train.edge_weight)

    def evaluate(self):
        """(n, 2 sides, 2) AUROC and AUPR on the host, as the loop reads
        them."""
        return torch.stack([
            self._evaluate(self.state.params, s, self.model_cfg)
            for s in (self.train, self.test)], dim=1).cpu().numpy()

    # -- the compared readings ---------------------------------------------
    def warm_up(self) -> dict:
        """The first ``compare_steps`` steps through the window's call, and
        one eval of each side: the program's readings."""
        out = {"loss": []}
        for i in range(self.traffic["compare_steps"]):
            out["loss"].append(self.step(1)[0].double().cpu())
            if i == 0:
                # The first gradient as Adam took it: its first moment
                # after one step over (1 - b1).
                out["grad"] = torch.stack([
                    torch.linalg.vector_norm(m.flatten(1), dim=1) / 0.1
                    for m in self.state.opt.mu]).cpu()
        out["loss"] = torch.stack(out["loss"]).numpy()
        out["draws"] = self.state.generator.get_state().numpy()
        start = P.make_params(self.spec, self.n_models, self.param_seed,
                              self.device)
        out["change"] = torch.stack([
            torch.linalg.vector_norm((t.detach() - s).flatten(1), dim=1)
            for (_, t), (_, s) in zip(P.leaves(self.state.params),
                                      P.leaves(start))]).cpu()
        del start
        out["eval"] = self.evaluate()
        return out

    def release(self):
        """Frees the program's state and inputs."""
        self.state = self.train = self.test = self._one_step = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control: str | None = None) -> dict:
        """The plain reference's readings; ``control`` names a lower
        precision to compute them in (see ``CONTROLS``)."""
        from gnnbench.reference import dense

        with precision(control == "tf32"):
            return dense.run(self.raw, self.cfg, self.traffic, self.spec,
                             self.param_seed, self.draw_seed, self.device,
                             steps=self.traffic["compare_steps"],
                             dec_dtype=bf16_points(control))

    # -- what the per-layer metrics count ---------------------------------
    def counts(self) -> dict:
        ops = counts.dense_step(self.cfg, self.nd, self.nv, self.cells)
        dec_ops, dec_bytes = counts.decoder_work(
            self.cfg, self.nd, self.nv, self.cells, self.mode == "edges")
        n = self.n_models
        return dict(step_ops={k: v * n for k, v in ops.items()},
                    decoder_least_s=n * counts.least_seconds(dec_ops,
                                                             dec_bytes),
                    decoder_kernels=DECODER_KERNELS[self.mode],
                    segment_sum_bytes=None)


# The controls: the reference computed in the nearest precision below each
# that the configurations state.  ``tf32``: the float32 products with TF32
# on, the bf16 points kept; ``fp8``: the bf16 points in fp8 (e4m3, a scale
# per tensor), the float32 products kept with TF32 off.
CONTROLS = ("tf32", "fp8")


class precision:
    """TF32 off (the configurations' float32), or on for the ``tf32``
    control."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.saved
        torch.backends.cudnn.allow_tf32 = self.saved


def bf16_points(control: str | None):
    """The type of the configuration's bf16 points: bf16 as it states,
    fp8 for the ``fp8`` control."""
    return torch.float8_e4m3fn if control == "fp8" else torch.bfloat16


def build(cfg: dict, traffic: dict, seed: int, device) -> Run:
    return Run(cfg, traffic, seed, device)

