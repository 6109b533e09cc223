"""Model configuration of the PyTorch/CUDA Lily (YouTube-VLN) port.

A copy of ``youtube_vln_tpu/config.py:LilyConfig`` (the port imports
nothing of the JAX package).  The JSON schema of
``bert_base_6_layer_6_connect.json`` loads unchanged; unknown keys are
ignored.  Differences from the JAX copy:

  * ``compute_dtype`` defaults to ``"bfloat16"``, the eval default of the
    JAX run configuration (``RunConfig.compute_dtype``); pass ``"float32"``
    for parity runs.
  * ``use_attention_kernels`` replaces ``use_pallas_attention``: it routes the vision self-attention and the
    co-attention layers through the hand-written CUDA kernels of
    ``ops/attention.py``.
  * ``use_epilogue_kernels`` is the counterpart of ``use_pallas_epilogue``
    and keeps its default (off).  It takes effect only together with
    ``use_attention_kernels``, as ``select_epilogue_fn`` requires
    ``use_pallas_attention``: then the dropout + residual + LayerNorm sites
    that ``ops/epilogue.py:use_epilogue_kernel_for`` selects (train mode,
    the 24 vision-stream sites of the flagship pretraining step) run the
    CUDA kernels B5/B6.
  * ``remat`` recomputes each encoder block in the backward with
    ``torch.utils.checkpoint`` where the JAX package uses ``jax.checkpoint``.

``RunConfig`` copies the fields of ``youtube_vln_tpu/config.py:RunConfig``
that the train step, the datasets, the loader and the command line read,
with the same defaults and the ``validate`` checks that concern them.
``compilation_cache_dir`` names the directory the CUDA kernels are built
and loaded in (``ops/_build.py:set_build_dir``), where the JAX package
points XLA's compilation cache.  ``mesh_shape`` / ``mesh_axes`` name the
``data`` and ``model`` axes (``parallel/mesh.py``: data parallelism over
``data``, the heads sharded over ``model``) and ``orbax_checkpoints``
saves ``torch.distributed.checkpoint`` directories.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple, Union


@dataclass
class LilyConfig:
    """Two-stream ViLBERT topology (reference ``vilbert/vilbert.py:129-171``)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    # vision stream
    v_feature_size: int = 2048
    v_target_size: int = 1601
    v_hidden_size: int = 768
    v_num_hidden_layers: int = 3
    v_num_attention_heads: int = 12
    v_intermediate_size: int = 3072
    v_attention_probs_dropout_prob: float = 0.1
    v_hidden_act: str = "gelu"
    v_hidden_dropout_prob: float = 0.1
    v_initializer_range: float = 0.2
    # cross-modal (co-attention) connection layers
    bi_hidden_size: int = 1024
    bi_num_attention_heads: int = 16
    v_biattention_id: Tuple[int, ...] = (0, 1)
    t_biattention_id: Tuple[int, ...] = (10, 11)
    # behaviour switches (reference defaults; mostly vestigial for Lily)
    predict_feature: bool = False
    fast_mode: bool = False
    fixed_v_layer: int = 0
    fixed_t_layer: int = 0
    in_batch_pairs: bool = False
    fusion_method: str = "mul"
    intra_gate: bool = False
    with_coattention: bool = True
    fusion_dropout_prob: float = 0.1
    # task heads enabled on the Lily wrapper (reference ``lily.py:117-127``)
    ranking: bool = True
    traj_judge: bool = False
    masked_language: bool = False
    masked_vision: bool = False
    # port knobs (no reference equivalent)
    compute_dtype: str = "bfloat16"     # "float32" | "bfloat16"
    use_attention_kernels: bool = True  # CUDA kernels B1-B4 (ops/attention.py)
    use_epilogue_kernels: bool = False  # CUDA kernels B5/B6 (ops/epilogue.py)
    remat: bool = False                 # recompute each encoder block in
                                        # the backward (models/vilbert.py)

    def __post_init__(self):
        self.v_biattention_id = tuple(self.v_biattention_id)
        self.t_biattention_id = tuple(self.t_biattention_id)
        assert len(self.v_biattention_id) == len(self.t_biattention_id)
        assert max(self.v_biattention_id) < self.v_num_hidden_layers
        assert max(self.t_biattention_id) < self.num_hidden_layers
        assert self.hidden_size % self.num_attention_heads == 0
        assert self.v_hidden_size % self.v_num_attention_heads == 0
        assert self.bi_hidden_size % self.bi_num_attention_heads == 0
        # the reference asserts the frozen prefix ends before every
        # co-attention block (vilbert.py:742-743); the binding bound is the
        # first block
        assert self.fixed_v_layer <= self.v_biattention_id[0], (
            self.fixed_v_layer, self.v_biattention_id)
        assert self.fixed_t_layer <= self.t_biattention_id[0], (
            self.fixed_t_layer, self.t_biattention_id)

    @classmethod
    def from_json_file(cls, json_file: Union[str, Path]) -> "LilyConfig":
        with open(json_file, "r", encoding="utf-8") as fid:
            params = json.load(fid)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in params.items() if k in known})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"

    def __repr__(self):
        return self.to_json_string()


# The topology of ``bert_base_6_layer_6_connect.json`` (1024-wide vision
# stream, 6 vision layers, a connection at every vision layer).
BERT_BASE_6_LAYER_6_CONNECT = dict(
    attention_probs_dropout_prob=0.1,
    hidden_act="gelu",
    hidden_dropout_prob=0.1,
    hidden_size=768,
    initializer_range=0.02,
    intermediate_size=3072,
    max_position_embeddings=512,
    num_attention_heads=12,
    num_hidden_layers=12,
    type_vocab_size=2,
    vocab_size=30522,
    v_feature_size=2048,
    v_target_size=1601,
    v_hidden_size=1024,
    v_num_hidden_layers=6,
    v_num_attention_heads=8,
    v_intermediate_size=1024,
    bi_hidden_size=1024,
    bi_num_attention_heads=8,
    v_attention_probs_dropout_prob=0.1,
    v_hidden_act="gelu",
    v_hidden_dropout_prob=0.1,
    v_initializer_range=0.02,
    v_biattention_id=(0, 1, 2, 3, 4, 5),
    t_biattention_id=(6, 7, 8, 9, 10, 11),
    fusion_method="mul",
)


def lily_base_config(**overrides) -> LilyConfig:
    """The flagship configuration used by all reference recipes."""
    cfg = dict(BERT_BASE_6_LAYER_6_CONNECT)
    cfg.update(overrides)
    return LilyConfig(**cfg)


def tiny_config(**overrides) -> LilyConfig:
    """A miniature topology for unit tests (fast on CPU)."""
    cfg = dict(
        vocab_size=256,
        hidden_size=32,
        num_hidden_layers=4,
        num_attention_heads=4,
        intermediate_size=64,
        v_feature_size=64,
        v_target_size=23,
        v_hidden_size=48,
        v_num_hidden_layers=2,
        v_num_attention_heads=4,
        v_intermediate_size=48,
        bi_hidden_size=48,
        bi_num_attention_heads=4,
        v_biattention_id=(0, 1),
        t_biattention_id=(2, 3),
        max_position_embeddings=64,
    )
    cfg.update(overrides)
    return LilyConfig(**cfg)


@dataclass
class RunConfig:
    """The training and data fields of the JAX package's ``RunConfig``
    (reference ``utils/cli.py`` names, so recipes translate 1:1)."""

    # tasks
    ranking: bool = False
    traj_judge: bool = False
    masked_vision: bool = False
    masked_language: bool = False
    traj_loss_scale: float = 1.0
    not_traj_judge_data: bool = False
    # data selection
    pretrain: bool = True
    pre_dataset: str = ""                 # "ytb" | "bnb" | ""
    prefix: str = ""
    r2r_prefix: str = ""
    beam_prefix: str = ""
    feather_note: str = ""
    data_dir: str = "data"
    img_feature: str = "data/matterport-ResNet-101-faster-rcnn-genome.lmdb"
    ytb_feature: Tuple[str, ...] = ()
    bnb_feature: Tuple[str, ...] = ()
    skeleton_path: str = "data/task/R2R_train_templates.json"
    bert_tokenizer: str = "bert-base-uncased"
    config_file: str = "data/config/bert_base_6_layer_6_connect.json"
    from_pretrained: str = ""
    # geometry
    max_instruction_length: int = 60
    max_path_length: int = 8
    max_num_boxes: int = 101
    min_path_length: int = 4
    min_captioned: int = 2
    max_captioned: int = 7
    # negatives / beams
    num_negatives: int = 2
    num_beams: int = 30
    num_beams_train: int = 4
    negative_style: str = "normal"
    shuffler: str = "different"
    shuffle_visual_features: bool = False
    ground_truth_trajectory: bool = False
    mask_action_rate: float = 0.0
    random_action: bool = False
    no_serial: bool = False
    out_listing: bool = False
    separators: bool = False
    # training
    batch_size: int = 2
    num_epochs: int = 20
    save_epochs: int = -1
    gradient_accumulation_steps: int = 1
    learning_rate: float = 4e-5
    warmup_proportion: float = 0.2
    cooldown_factor: float = 2.0
    weight_decay: float = 1e-2
    no_scheduler: bool = False
    ConstantLR: bool = False
    lr_schedule: str = "warmup_linear"  # a key of training.optimization.SCHEDULES
    sparse_task_heads: bool = True      # decoders only on target rows
    resume: bool = False
    seed: int = 1
    num_workers: int = 3
    # eval / run management
    mini: bool = False
    debug: bool = False
    no_test: bool = False
    skip_val: bool = False
    skip_all_reduce: bool = False
    output_dir: str = "result"
    save_name: str = ""
    note: str = ""
    # data parallelism: () puts every process on the data axis
    mesh_shape: Tuple[int, ...] = ()
    mesh_axes: Tuple[str, ...] = ("data", "model")
    # model knobs folded into LilyConfig by utils/entry.py
    compute_dtype: str = "bfloat16"
    use_attention_kernels: bool = True  # counterpart of use_pallas_attention
    # transport
    io_dtype: str = "float16"           # host->device dtype of features
                                        # and targets; the model upcasts
    sparse_vision_targets: bool = True  # ship only the masked-region
                                        # target rows
    dedup_candidates: Optional[bool] = None  # ship each unique trajectory's
                                        # visual rows once per sample;
                                        # None follows sparse_vision_targets
    dedup_beam_steps: bool = True       # beam eval: ship each unique
                                        # (viewpoint, heading, step) pano
                                        # block once + a per-beam step
                                        # index, expanded on the device
    remat: bool = False                 # recompute each encoder block in
                                        # the backward
    profile_dir: str = ""               # torch.profiler trace of steps
                                        # 2-8 of the first epoch
    compilation_cache_dir: str = ""     # where the CUDA kernels are built
                                        # and loaded ("": build/kernels)
    host_prefetch: int = 2              # batches copied ahead of their use
    orbax_checkpoints: bool = False     # torch.distributed.checkpoint
                                        # directories written by every rank

    def __post_init__(self):
        # tri-state: None means "follow sparse_vision_targets", so the pair
        # defaults on together and turning sparse targets off alone
        # restores the dense transport
        if self.dedup_candidates is None:
            self.dedup_candidates = self.sparse_vision_targets

    def validate(self) -> None:
        """Reference ``utils/utils_init.py:13-23`` (val_args)."""
        if not (self.masked_vision or self.masked_language or self.ranking
                or self.traj_judge):
            raise ValueError(
                "No training objective selected, add --masked_vision, "
                "--masked_language, --ranking, or --traj_judge")
        if (not self.pretrain and self.traj_judge
                and ((self.ranking or self.not_traj_judge_data)
                     ^ self.shuffle_visual_features)):
            raise ValueError(
                "when finetuning, traj_judge requires matching "
                "--shuffle_visual_features usage")
        if self.dedup_candidates and not self.sparse_vision_targets:
            raise ValueError(
                "--dedup_candidates requires --sparse_vision_targets "
                "(dense [nc, S, 1601] vision targets would repay the "
                "transport saving)")
