"""The plain reference against the port at a small size on the CPU, where
the port runs its kernels' plain versions: the same weights, inputs and
dropout seeds give the same scores, losses and gradients to float32
rounding, with dropout on at every kind of site (Philox attention and
epilogue sites, generator sites)."""
import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import lily as ref_lily
from benchmark.reference import train as ref_train
from benchmark.tests import small


def _batch(cfg, seed):
    from youtube_vln_tpu_torch.utils.measure import pretrain_batch
    b = pretrain_batch(cfg, 2, 3, 16, 132, seed=seed)
    b["image_features"] = b["image_features"].astype(np.float16)
    return b


@pytest.mark.parametrize("name", ["lily_ranker", "lily_mrt"])
def test_reference_matches_the_port(name, monkeypatch):
    from youtube_vln_tpu_torch.config import RunConfig
    from youtube_vln_tpu_torch.models import Lily
    from youtube_vln_tpu_torch.parallel import train_step as ts
    small.fuse_everywhere(monkeypatch)
    cell = small.cell({"lily_ranker": "finetune.30rs",
                       "lily_mrt": "pretrain.mrt_ytb"}[name])
    model = harness.model_dict(cell.config)
    cfg = harness.port_config(cell.config)
    weights = ref_lily.make_weights(model, 2 ** 33 + 5, "cpu")
    net = Lily(cfg, device="cpu")
    net.load_state_dict(weights, strict=True)
    batch = _batch(cfg, 3)

    net.eval()
    with torch.no_grad():
        flat = ts.flatten_candidates({k: torch.as_tensor(v) for k, v in batch.items()})
        got = net(flat["instr_tokens"], flat["image_features"], flat["image_locations"],
                  token_type_ids=flat["segment_ids"], attention_mask=flat["instr_mask"],
                  image_attention_mask=flat["image_mask"])["ranking"].reshape(2, 3)
    want = ref_train.scores(weights, model, batch, rows_per_block=4)
    assert torch.allclose(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))

    run = dict(cell.traffic["run"], steps_per_epoch=10, warmup_proportion=0.0,
               learning_rate=1e-3)
    args = RunConfig(**{k: v for k, v in run.items() if k != "steps_per_epoch"})
    args.validate()
    opt, _ = ts.create_train_state(net, args, steps_per_epoch=10)
    step = ts.build_train_step(net, cfg, args, opt, device="cpu")
    seeds = [2 ** 63 + 11, 5]
    losses = [float(step(batch, s)["loss/train"]) for s in seeds]
    ref_weights = {k: v.clone() for k, v in weights.items()}
    ref_weights[ref_lily.TIED[0]] = ref_weights[ref_lily.TIED[1]]
    ref_losses, _ = ref_train.follow_steps(ref_weights, model, run, [batch, batch],
                                           seeds, instr_per_block=1)
    assert losses == pytest.approx(ref_losses, rel=1e-5)
    for k, p in net.named_parameters():
        assert torch.allclose(p.detach(), ref_weights[k], rtol=0, atol=2e-5), k
