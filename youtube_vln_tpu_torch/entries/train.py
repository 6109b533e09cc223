"""R2R fine-tuning entry point (the counterpart of the repo's ``train.py``,
reference ``train.py``).

    python -m youtube_vln_tpu_torch.entries.train --ranking \\
        --shuffle_visual_features --batch_size 16 ... [--device cpu]

Epoch loop: train -> periodic save -> val_seen/val_unseen success-rate
validation -> best_seen/best_unseen checkpoints (reference train.py:100-188),
on the CUDA device (``--device cpu`` runs on the CPU instead).  Checkpoints
go to ``{output_dir}/{save_name}/data``, the log and config dump to
``{output_dir}/{save_name}/train{N}_{time}_{note}_``.

Data-parallel, one process per GPU (``--batch_size`` is the global batch):

    torchrun --nproc_per_node N -m youtube_vln_tpu_torch.entries.train ...

Rank 0 writes the log, the config dump, the code snapshot and the ``.bin``
checkpoints; with ``--orbax_checkpoints`` every rank writes its part of a
``.dcp`` directory.  Every decision that leads to a save is rank 0's,
broadcast, so no rank waits at a collective save that another skips.
"""
from pathlib import Path

from ..device import resolve_device
from ..ops._build import set_build_dir
from ..parallel.distributed import (broadcast_host, initialize,
                                    is_main_process, rank)
from ..training import checkpoint as ckpt
from ..training.engine import Engine
from ..utils.cli import args_to_run_config, get_parser
from ..utils.entry import build_model_config
from ..utils.misc import (NoneLogger, dump_config, get_logger, get_output_dir,
                          save_code_snapshot, set_seed)


def start(ns, args):
    """The set-up common to the training entries, in order: the device
    and the process group (``initialize``), the kernels' build directory
    (``--compilation_cache_dir``), the seeds, the run folders
    (``open_run``), the model config and, on rank 0, its dump and the code
    snapshot.  Returns (device, model_save_path, logger, writer, cfg)."""
    device = initialize(resolve_device(ns.device))
    set_build_dir(args.compilation_cache_dir)
    set_seed(args.seed, rank())
    save_folder, model_save_path, logger, writer = open_run(ns, is_main_process())
    cfg = build_model_config(args)
    if is_main_process():
        dump_config(save_folder, ns, cfg)
        save_code_snapshot(save_folder)
    return device, model_save_path, logger, writer, cfg


def open_run(ns, main: bool = True):
    """(save_folder, model_save_path, logger, writer) of a training run:
    the run folder with its log, the checkpoint folder, and a tensorboardX
    writer where tensorboardX is installed.  On a rank other than 0 only
    the checkpoint folder: (None, model_save_path, NoneLogger(), None)."""
    if not main:
        return (None, (Path(ns.output_dir) / ns.save_name).resolve() / "data",
                NoneLogger(), None)
    save_folder = get_output_dir(ns)
    model_save_path = save_folder.parent / "data"
    save_folder.mkdir(parents=True, exist_ok=True)
    logger = get_logger(__name__, str(save_folder / "train.log"))
    logger.info(f"Experiment Folder: {save_folder}")
    model_save_path.mkdir(parents=True, exist_ok=True)
    writer = None
    try:
        from tensorboardX import SummaryWriter
        writer = SummaryWriter(logdir=str(save_folder.parent / "tb"),
                               flush_secs=30)
    except ImportError:
        pass
    return save_folder, model_save_path, logger, writer


def save_epoch(engine: Engine, args, model_save_path, epoch: int) -> None:
    """The periodic save (rank 0's decision) and rank 0's prune of the one
    before it."""
    if broadcast_host((args.save_epochs != -1
                       and (epoch + 1) % args.save_epochs == 0)
                      or epoch == args.num_epochs - 1):
        engine.save(str(epoch), epoch)
        if is_main_process():
            ckpt.delete_checkpoint(model_save_path,
                                   str(epoch - args.save_epochs))


def main(argv=None):
    """Runs the fine-tuning; returns (best_seen, best_unseen) ranking
    accuracies."""
    parser = get_parser()
    ns = parser.parse_args(argv)
    ns.pretrain = False  # reference train.py:24
    args = args_to_run_config(ns)
    args.validate()
    device, model_save_path, logger, writer, cfg = start(ns, args)

    engine = Engine(args, cfg, save_folder=model_save_path,
                    run_logger=logger, device=device)
    engine.writer = writer

    best_seen = 0.0
    best_unseen = 0.0
    logger.info(f"starting training from epoch {engine.start_epoch}...")
    for epoch in range(engine.start_epoch, args.num_epochs):
        logger.info(f"epoch {epoch}")
        engine.train_epoch(epoch)
        save_epoch(engine, args, model_save_path, epoch)

        if not args.skip_val and args.ranking and not args.no_test:
            # rank 0's accuracies decide the saves on every rank
            seen = broadcast_host(engine.evaluate("val_seen", epoch).get(
                "accuracy/ranking", 0.0))
            if seen >= best_seen:
                best_seen = seen
                engine.save("best_seen", epoch)
            unseen = broadcast_host(engine.evaluate("val_unseen", epoch).get(
                "accuracy/ranking", 0.0))
            if unseen >= best_unseen:
                best_unseen = unseen
                engine.save("best_unseen", epoch)
            logger.info(
                f"epoch {epoch} sr_val_seen={seen:.3f} "
                f"(best {best_seen:.3f}) sr_val_unseen={unseen:.3f} "
                f"(best {best_unseen:.3f})")

    if writer is not None:
        writer.close()
    engine.close()
    logger.info("Finish~~~")
    return best_seen, best_unseen


if __name__ == "__main__":
    main()
