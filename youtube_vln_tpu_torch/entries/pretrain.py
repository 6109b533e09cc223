"""Pretraining entry point (the counterpart of the repo's ``pretrain.py``,
reference ``pretrain.py``).

    python -m youtube_vln_tpu_torch.entries.pretrain --pre_dataset ytb \\
        --prefix merge+ --masked_vision --masked_language --ranking \\
        --traj_judge --batch_size 8 --learning_rate 2e-5 ... [--device cpu]

Epoch loop: train -> periodic save + prune -> test_epoch on the YTb test
split -> best-per-task checkpoints (reference pretrain.py:104-164), on the
CUDA device (``--device cpu`` runs on the CPU instead).  Data-parallel as
``entries/train.py`` describes:

    torchrun --nproc_per_node N -m youtube_vln_tpu_torch.entries.pretrain ...
"""
from ..parallel.distributed import broadcast_host
from ..training.engine import Engine
from ..utils.cli import args_to_run_config, get_parser
from .train import save_epoch, start


def main(argv=None):
    """Runs the pretraining; returns the best accuracy of each evaluated
    task (``ranking``, ``traj``)."""
    parser = get_parser()
    parser.add_argument("--final", default=False, action="store_true")
    ns = parser.parse_args(argv)
    args = args_to_run_config(ns)
    args.validate()
    device, model_save_path, logger, writer, cfg = start(ns, args)

    engine = Engine(args, cfg, save_folder=model_save_path,
                    run_logger=logger, device=device)
    engine.writer = writer

    best = {}
    if args.ranking:
        best["ranking"] = 0.0
    if args.traj_judge:
        best["traj"] = 0.0

    logger.info(f"starting training from epoch {engine.start_epoch}...")
    for epoch in range(engine.start_epoch, args.num_epochs):
        logger.info(f"epoch {epoch}")
        engine.train_epoch(epoch)
        save_epoch(engine, args, model_save_path, epoch)

        if not args.skip_val and (args.ranking or args.traj_judge):
            stats = engine.evaluate("test", epoch)
            for task in best:
                # rank 0's accuracy decides the save on every rank
                acc = broadcast_host(stats.get(f"accuracy/{task}", 0.0))
                if acc >= best[task]:
                    best[task] = acc
                    engine.save(f"best_{task}", epoch)

    if writer is not None:
        writer.close()
    engine.close()
    logger.info("Finish~~~")
    return best


if __name__ == "__main__":
    main()
