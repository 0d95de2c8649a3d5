"""Typed configuration for the PyTorch port of DREAM-GNN-TPU.

A copy of ``dream_gnn_tpu/config.py``: the same dataclasses, field names
and defaults, so a configuration means the same in both packages.

The reference drives everything through a mutable argparse namespace
(reference ``train.py:403-452``) that is mutated at runtime to
carry derived dimensions (``train.py:172-179``) and passed whole into
the model.  Here the same knobs live in frozen dataclasses: flag names
are kept for CLI parity, derived dimensions are computed once in
``ModelConfig.derive``.

Dead reference flags (``l2_reg_weight``, ``use_gate_attention``,
``Two_Stage`` — see SURVEY.md §5) are intentionally not carried.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (reference ``Net(args)``, model.py:5-58)."""

    # Input dims (derived from data; reference train.py:172-175)
    src_in_units: int = 768       # drug embedding dim
    dst_in_units: int = 768       # disease embedding dim
    fdim_drug: int = 0            # n_drug  (FGCN input dim = node count)
    fdim_disease: int = 0         # n_disease
    num_ratings: int = 2          # |rating_vals| == {0, 1}

    # GCMC route (reference layers.py:18-143)
    layers: int = 3
    gcn_agg_units: int = 1024
    gcn_agg_accum: str = "sum"    # 'sum' | 'stack'
    gcn_out_units: int = 128
    basis_units: int = 2
    share_param: bool = True
    model_activation: str = "leaky"

    # FGCN route (reference layers.py:251-285)
    nhid1: int = 768
    nhid2: int = 128

    # Fusion + decoder
    attention_hidden: int = 16
    attention_dropout: float = 0.1
    decoder_hidden1: int = 128
    decoder_hidden2: int = 64

    # Regularisation
    dropout: float = 0.3

    # Decoder matmul operand dtype ('float32' | 'bfloat16').
    # Params, accumulation, and outputs stay float32 either way.
    compute_dtype: str = "float32"

    # Decoder backend: 'pallas' names the fused kernels (in this package the
    # CUDA kernels of kernels/edge_decoder.py and kernels/grid_decoder.py);
    # 'xla' the plain decoders of nn/decoder.py, which launch no kernel of
    # their own.
    decoder_backend: str = "xla"

    # Decode mode: 'edges' scores the candidate pair list (works at any
    # scale); 'grid' scores the whole n_drug x n_dis grid with no
    # per-edge gathers (kernels/grid_decoder.py) and masks
    # out-of-fold cells via the loss/metric weights — the fast path for
    # reference-scale datasets where candidates cover ~90% of the grid.
    decode_mode: str = "edges"

    # The model kind (model/kinds.py): 'dream' (DREAM-GNN's dual route,
    # model/dream_gnn.py) or 'gcmc' (GCMC alone, as DGL's
    # examples/pytorch/gcmc trains it with --use_one_hot_fea,
    # model/gcmc_alone.py: one 'stack' GCMC layer on one-hot inputs,
    # src_in_units and dst_in_units being the user and item counts, then
    # the bilinear decoder with gen_r_num_basis_func basis matrices and a
    # softmax over the num_ratings levels).
    model_kind: str = "dream"
    gen_r_num_basis_func: int = 2
    # The value of each rating level, for GCMC's expected-rating RMSE.
    rating_values: Sequence[float] = ()

    def effective_msg_units(self, layer_idx: int) -> int:
        """Message dim of GCMC layer ``layer_idx``.

        Mirrors reference layers.py:50-57: under 'stack' the agg units
        are divided by the number of ratings; the first layer further
        divides by 3 (1024 -> 341 under defaults).
        """
        msg = self.gcn_agg_units if layer_idx == 0 else (
            self.gcn_out_units * self.num_ratings
            if self.gcn_agg_accum == "stack" else self.gcn_out_units)
        if self.gcn_agg_accum == "stack":
            assert msg % self.num_ratings == 0
            msg //= self.num_ratings
        if layer_idx == 0:
            # ini=True only for the first layer (model.py:10,39)
            msg //= 3
        return msg

    def layer_in_units(self, layer_idx: int) -> int:
        return self.src_in_units if layer_idx == 0 else self.gcn_out_units


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Stochastic augmentation applied inside the jitted train step.

    The reference applies augmentation unconditionally every iteration
    (train.py:238,267 — ``--use_augmentation`` only gates a separate
    loader-side path).  Methods and defaults mirror train.py:432-442.
    """

    methods: Sequence[str] = ("edge_dropout", "feature_noise")
    edge_dropout_rate: float = 0.1
    add_edge_rate: float = 0.03
    feature_noise_scale: float = 0.05
    sim_noise_scale: float = 0.05       # augmentation.py:476 (never overridden)
    graph_noise_scale: float = 0.03
    feature_mask_rate: float = 0.1
    mixup_alpha: float = 0.2


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training protocol (reference train.py argparse defaults)."""

    data_name: str = "Gdataset"
    save_dir: str = "seed_experiments"
    num_neighbor: int = 4               # CLI default (train.py:423); loader's own default is 5
    gcn_agg_norm_symm: bool = True

    train_lr: float = 0.002
    weight_decay: float = 1e-5
    train_grad_clip: float = 1.0
    train_max_iter: int = 18000
    train_valid_interval: int = 250
    beta: float = 0.001                 # common-loss weight
    label_smoothing: float = 0.0

    # ReduceLROnPlateau(max, patience=500, factor=0.5)  train.py:235
    plateau_patience: int = 500
    plateau_factor: float = 0.5

    n_folds: int = 10
    seeds: Sequence[int] = (77, 31415, 888, 1001, 9999, 0, 42, 123, 2024, 7)
    kfold_seed: int = 1024              # data_loader.py:154

    save_model: bool = False
    generate_top_predictions: bool = False
    top_k: int = 200
    # Reference --use_augmentation: gates ONLY the loader-side feature
    # augmentation consumed by novel prediction (data_loader.py:518,559
    # — the train loop's per-iteration augmentation is always on
    # regardless; parity trap SURVEY §7.3.2).
    use_augmentation: bool = False
    # Periodic full-state checkpointing for preemption recovery (0 =
    # off); must be a multiple of train_valid_interval to take effect.
    checkpoint_every: int = 0
    # Resume from checkpoints found under save_dir (written by
    # checkpoint_every); a preempted protocol run continues where it
    # stopped with an identical PRNG/optimizer/LR-schedule stream.
    resume: bool = False

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    augment: AugmentConfig = dataclasses.field(default_factory=AugmentConfig)

    # PRNG implementation name of the JAX package, kept for CLI parity;
    # the port draws from one torch.Generator per fold whatever it says.
    rng_impl: str = "rbg"


def wide_model_config(**overrides) -> ModelConfig:
    """BASELINE.json config 4: 512-dim hidden, 5 GCN layers, dense
    similarity SpMM, intended for 1-host multi-chip data-parallel folds
    (sharding/partition.py)."""
    base = dict(layers=5, gcn_agg_units=1536, gcn_out_units=512,
                nhid1=768, nhid2=512, compute_dtype="bfloat16")
    base.update(overrides)
    return ModelConfig(**base)
