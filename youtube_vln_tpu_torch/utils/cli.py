"""Command-line surface (a copy of ``youtube_vln_tpu/utils/cli.py``).

The flag set is the JAX parser's, option for option, with the same
defaults, so the published recipes (README.md:103-183) run unchanged;
``--device`` defaults to ``cuda`` and takes ``cpu`` on request.  Parsed
args fold into one :class:`~youtube_vln_tpu_torch.config.RunConfig`;
``--no_pallas`` maps to ``use_attention_kernels=False``.
``--mesh_shape`` / ``--mesh_axes`` name the ``data`` and ``model`` axes
(``parallel/mesh.py``: data parallelism and tensor parallelism; the
Engine refuses a shape whose product is not the world size) and
``--orbax_checkpoints`` saves ``torch.distributed.checkpoint`` directories.
``--compilation_cache_dir DIR`` is where the entries build and load the
CUDA kernels (``ops/_build.py:set_build_dir``), the counterpart of the XLA
compilation cache.  A flag of the JAX package with no counterpart here yet
would be listed in ``TPU_ONLY`` and refused unless left at its default;
none is left.

Note: the reference's ``boolean_string`` helper returns False for every
accepted input (cli.py:4-9), making ``--in_memory`` and
``--ground_truth_trajectory`` effectively always False.  We parse booleans
correctly but keep the same defaults, so effective behavior matches.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

from ..config import RunConfig
from ..parallel.mesh import mesh_extents

# flag -> (default, the ROADMAP.md item that will port it)
TPU_ONLY: dict = {}


def boolean_string(s: str) -> bool:
    if s in {"False", "0", "false"}:
        return False
    if s in {"True", "1", "true"}:
        return True
    raise ValueError("Not a valid boolean string")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="YouTube-VLN (Lily) on PyTorch and CUDA")

    # tasks
    p.add_argument("--masked_vision", action="store_true", default=False)
    p.add_argument("--masked_language", action="store_true", default=False)
    p.add_argument("--ranking", action="store_true", default=False)
    p.add_argument("--traj_judge", action="store_true", default=False)
    p.add_argument("--traj_loss_scale", default=1.0, type=float)
    p.add_argument("--not_traj_judge_data", action="store_true",
                   default=False)

    # data selection
    p.add_argument("--pre_dataset", type=str,
                   choices=["", "ytb", "bnb"], default="")
    p.add_argument("--pretrain", type=boolean_string, default=True)
    p.add_argument("--prefix", default="", type=str)
    p.add_argument("--r2r_prefix", default="", type=str)
    p.add_argument("--beam_prefix", default="", type=str)
    p.add_argument("--feather_note", default="", type=str)
    p.add_argument("--data_dir", default="data", type=str)
    p.add_argument("--img_feature",
                   default="data/matterport-ResNet-101-faster-rcnn-genome"
                           ".lmdb", type=str)
    p.add_argument("--ytb_feature", nargs="+", type=str, default=[
        f"data/YouTube-VLN/youtube_img_features/img_features_{i}"
        for i in range(11)])
    p.add_argument("--bnb_feature", nargs="+", type=str, default=[
        f"data/img_features/img_features_{i}" for i in range(20)])
    p.add_argument("--skeleton_path",
                   default="data/task/R2R_train_templates.json", type=str)
    p.add_argument("--bert_tokenizer", default="bert-base-uncased", type=str)
    p.add_argument("--config_file",
                   default="data/config/bert_base_6_layer_6_connect.json",
                   type=str)
    p.add_argument("--from_pretrained", default="bert-base-uncased",
                   type=str)
    p.add_argument("--in_memory", default=False, type=boolean_string)

    # geometry
    p.add_argument("--max_instruction_length", default=60, type=int)
    p.add_argument("--max_path_length", default=8, type=int)
    p.add_argument("--max_num_boxes", default=101, type=int)
    p.add_argument("--min_path_length", default=4, type=int)
    p.add_argument("--min_captioned", default=2, type=int)
    p.add_argument("--max_captioned", default=7, type=int)

    # negatives / beams
    p.add_argument("--num_beams", default=30, type=int)
    p.add_argument("--num_beams_train", default=4, type=int)
    p.add_argument("--num_negatives", default=2, type=int)
    p.add_argument("--negative_style", default="normal", type=str,
                   choices=["normal", "shuffle_instruction", "another_path",
                            "another_destination"])
    p.add_argument("--shuffler", default="different", type=str,
                   choices=["different", "nonadj", "two"])
    p.add_argument("--shuffle_visual_features", action="store_true",
                   default=False)
    p.add_argument("--ground_truth_trajectory", default=False,
                   type=boolean_string)
    p.add_argument("--mask_action_rate", default=0.0, type=float)
    p.add_argument("--random_action", action="store_true", default=False)
    p.add_argument("--no_serial", action="store_true", default=False)
    p.add_argument("--out_listing", action="store_true", default=False)
    p.add_argument("--separators", action="store_true", default=False)
    p.add_argument("--combine_dataset", action="store_true", default=False)

    # training
    p.add_argument("--batch_size", default=2, type=int)
    p.add_argument("--num_epochs", default=20, type=int)
    p.add_argument("--save_epochs", default=-1, type=int)
    p.add_argument("--gradient_accumulation_steps", default=1, type=int)
    p.add_argument("--learning_rate", default=4e-5, type=float)
    p.add_argument("--warmup_proportion", default=0.2, type=float)
    p.add_argument("--cooldown_factor", default=2.0, type=float)
    p.add_argument("--weight_decay", default=1e-2, type=float)
    p.add_argument("--no_scheduler", action="store_true", default=False)
    p.add_argument("--ConstantLR", action="store_true", default=False)
    p.add_argument("--lr_schedule", default="warmup_linear",
                   choices=["warmup_linear", "warmup_constant",
                            "warmup_cosine",
                            "warmup_cosine_hard_restarts"],
                   help="LR decay family (reference optimization.py:26-103; "
                        "all published recipes use warmup_linear)")
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("-j", "--num_workers", default=3, type=int)

    # eval / run management
    p.add_argument("--mini", action="store_true", default=False)
    p.add_argument("--debug", action="store_true", default=False)
    p.add_argument("--no_test", action="store_true", default=False)
    p.add_argument("--skip_val", action="store_true", default=False)
    p.add_argument("--skip_all_reduce", action="store_true", default=False)
    p.add_argument("--output_dir", default="result", type=str)
    p.add_argument("--save_name", default="", type=str)
    p.add_argument("--note", default="", type=str)

    # legacy/compat flags accepted but unused
    p.add_argument("--rank", default=-1, type=int)
    p.add_argument("--local_rank", default=-1, type=int)
    p.add_argument("--world_size", default=-1, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   choices=["cuda", "cpu"],
                   help="where the model runs; cpu only when asked for")
    p.add_argument("--model_name", default="vilbert", type=str,
                   choices=["vilbert"])
    p.add_argument("--dataset", default="r2r", type=str)
    p.add_argument("--np", action="store_true", default=False)
    p.add_argument("--window", default=20, type=int)

    # transport and kernels, in the JAX parser's order
    tpu = p.add_argument_group("transport and kernels")
    tpu.add_argument("--mesh_shape", nargs="*", type=int, default=[])
    tpu.add_argument("--mesh_axes", nargs="*", type=str,
                     default=["data", "model"])
    tpu.add_argument("--compute_dtype", default="bfloat16", type=str,
                     choices=["bfloat16", "float32"])
    tpu.add_argument("--io_dtype", default="float16", type=str,
                     choices=["float16", "float32"])
    tpu.add_argument("--dense_task_heads", action="store_true",
                     default=False,
                     help="disable the sparse (gathered) MLM/MVM head "
                          "compute; loss-identical, slower")
    tpu.add_argument("--sparse_vision_targets", action="store_true",
                     default=True,
                     help="ship only masked-region target rows (~10x "
                          "smaller host batch; loss-exact) - DEFAULT ON")
    tpu.add_argument("--no_sparse_vision_targets",
                     dest="sparse_vision_targets", action="store_false",
                     help="reference-shaped dense [nc, S, 1601] vision "
                          "targets (for A/B transport comparisons)")
    tpu.add_argument("--dedup_candidates", action="store_true",
                     default=None,
                     help="ship shared candidate trajectories' visual rows "
                          "once per sample + a gather index (expanded "
                          "on the device, bit-exact); needs "
                          "--sparse_vision_targets.  Default: follows "
                          "sparse_vision_targets (i.e. ON)")
    tpu.add_argument("--no_dedup_candidates", dest="dedup_candidates",
                     action="store_false")
    tpu.add_argument("--dedup_beam_steps", action="store_true",
                     default=True,
                     help="beam-eval transport: ship each unique "
                          "(viewpoint, heading, step) pano block once per "
                          "instruction + a per-beam step index, expanded "
                          "on the device (bit-exact; self-gates to eval "
                          "items with masked-vision off) - DEFAULT ON")
    tpu.add_argument("--no_dedup_beam_steps", dest="dedup_beam_steps",
                     action="store_false",
                     help="reference-shaped dense per-beam eval transport "
                          "(for A/B transport comparisons)")
    tpu.add_argument("--no_pallas", action="store_true", default=False,
                     help="run the attention on its plain PyTorch version "
                          "instead of the CUDA kernels")
    tpu.add_argument("--remat", action="store_true", default=False)
    tpu.add_argument("--profile_dir", default="", type=str)
    tpu.add_argument("--compilation_cache_dir", default="", type=str)
    tpu.add_argument("--host_prefetch", default=2, type=int)
    tpu.add_argument("--orbax_checkpoints", action="store_true",
                     default=False)
    return p


def args_to_run_config(args: argparse.Namespace) -> RunConfig:
    for name, (default, item) in TPU_ONLY.items():
        value = getattr(args, name, default)
        if (list(value) if isinstance(value, (list, tuple)) else value) != default:
            raise ValueError(f"--{name} {value!r}: not ported to this package "
                             f"yet; ROADMAP.md Queue A item {item} ports it")
    # the shape is resolved against the world size by the Engine
    mesh_extents(args.mesh_shape, args.mesh_axes)
    fields = {f.name for f in dataclasses.fields(RunConfig)}
    kv = {}
    for k, v in vars(args).items():
        if k in fields:
            kv[k] = tuple(v) if isinstance(v, list) else v
    kv["use_attention_kernels"] = not getattr(args, "no_pallas", False)
    kv["sparse_task_heads"] = not getattr(args, "dense_task_heads", False)
    return RunConfig(**kv)


def parse_run_config(argv: Optional[Sequence[str]] = None,
                     parser: Optional[argparse.ArgumentParser] = None):
    parser = parser or get_parser()
    args = parser.parse_args(argv)
    return args, args_to_run_config(args)
