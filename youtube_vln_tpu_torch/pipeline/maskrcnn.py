"""Step 5b: the Mask R-CNN (ResNet-50-FPN) person detector in PyTorch
(counterpart of ``youtube_vln_tpu/pipeline/maskrcnn.py``).

The reference drives torchvision's ``maskrcnn_resnet50_fpn(pretrained=True)``
for one bit per frame: is a person among the top-5 detections
(``filter_outdoor_maskrcnn_coco.py:87-118``).  Only the detection path is
needed:

  image -> normalise / resize -> ResNet-50 (frozen BN) -> FPN (P2..P6)
        -> RPN head -> proposals (decode + level-wise NMS)
        -> MultiScale RoIAlign (P2..P5) -> TwoMLP box head -> class scores
        -> per-class NMS -> top-100 detections sorted by score

The convolutions, the RoIAlign and the box head run on the module's device
(torchvision is not used: the card machine has none); the control glue
(anchors, box decoding, NMS, level assignment) is the JAX package's numpy
code, run on the host as there.  ``MaskRCNN`` holds the weights under
torchvision's key names with FrozenBatchNorm buffers (``weight``, ``bias``,
``running_mean``, ``running_var``, eps 1e-5); a torchvision state dict
loads with ``strict=True`` whichever layout its FPN and RPN convs have
(``inner_blocks.i`` or ``inner_blocks.i.0``, ``rpn.head.conv`` or
``rpn.head.conv.0.0``), its mask branch ignored.  The JAX package pads the
RoI count of each level to a power of two to bound its jit variants; the
port pools the RoIs it has, with the same rows out.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import check_device, make_generator, resolve_device
from .resize import resize

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

PERSON_LABEL = 1          # COCO category id for 'person'
FROZEN_BN_EPS = 1e-5

# inference-time hyperparameters (torchvision MaskRCNN defaults)
RPN_PRE_NMS_TOP_N = 1000
RPN_POST_NMS_TOP_N = 1000
RPN_NMS_THRESH = 0.7
RPN_SCORE_THRESH = 0.0
RPN_MIN_SIZE = 1e-3
BOX_SCORE_THRESH = 0.05
BOX_NMS_THRESH = 0.5
DETECTIONS_PER_IMG = 100
NUM_CLASSES = 91
ANCHOR_SIZES = (32, 64, 128, 256, 512)
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
FPN_STRIDES = (4, 8, 16, 32, 64)
BBOX_XFORM_CLIP = math.log(1000.0 / 16)
RESNET50_BLOCKS = (3, 4, 6, 3)


# --------------------------------------------------------------------------- #
# modules (torchvision key names)
# --------------------------------------------------------------------------- #
class FrozenBatchNorm2d(nn.Module):
    """torchvision's FrozenBatchNorm2d: y = x * w / sqrt(var + eps) + (b -
    mean * w / sqrt(var + eps)), the statistics as buffers."""

    def __init__(self, c: int, eps: float = FROZEN_BN_EPS, device=None):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(c, device=device))
        self.register_buffer("bias", torch.zeros(c, device=device))
        self.register_buffer("running_mean", torch.zeros(c, device=device))
        self.register_buffer("running_var", torch.ones(c, device=device))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kw):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kw)

    def forward(self, x):
        scale = self.weight * (self.running_var + self.eps).rsqrt()
        shift = self.bias - self.running_mean * scale
        return x * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck: the stride on the 3x3 conv."""

    def __init__(self, cin: int, planes: int, stride: int, down: bool, device):
        super().__init__()
        out = planes * 4
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False, device=device)
        self.bn1 = FrozenBatchNorm2d(planes, device=device)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False, device=device)
        self.bn2 = FrozenBatchNorm2d(planes, device=device)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False, device=device)
        self.bn3 = FrozenBatchNorm2d(out, device=device)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, out, 1, stride, bias=False, device=device),
            FrozenBatchNorm2d(out, device=device)) if down else None)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(h + r)


class ResNet50Body(nn.Module):
    def __init__(self, device):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False, device=device)
        self.bn1 = FrozenBatchNorm2d(64, device=device)
        cin = 64
        for li, n in enumerate(RESNET50_BLOCKS):
            planes = 64 * 2 ** li
            blocks = [Bottleneck(cin if bi == 0 else planes * 4, planes,
                                 (1 if li == 0 else 2) if bi == 0 else 1,
                                 bi == 0, device) for bi in range(n)]
            cin = planes * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        cs = []
        for li in range(4):
            x = getattr(self, f"layer{li + 1}")(x)
            cs.append(x)
        return cs


class FPN(nn.Module):
    def __init__(self, device):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            nn.Conv2d(c, 256, 1, device=device) for c in (256, 512, 1024, 2048))
        self.layer_blocks = nn.ModuleList(
            nn.Conv2d(256, 256, 3, 1, 1, device=device) for _ in range(4))

    def forward(self, cs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """[C2..C5] -> [P2, P3, P4, P5, P6]: 1x1 laterals, nearest top-down
        (``jax.image.resize`` "nearest"), 3x3 smoothing, and
        LastLevelMaxPool (``max_pool2d(k=1, s=2)`` of P5)."""
        inner = [blk(c) for blk, c in zip(self.inner_blocks, cs)]
        outs = [None] * 4
        last = inner[3]
        outs[3] = self.layer_blocks[3](last)
        for i in (2, 1, 0):
            last = inner[i] + resize(last, inner[i].shape[-2:], "nearest")
            outs[i] = self.layer_blocks[i](last)
        return outs + [F.max_pool2d(outs[3], 1, 2, 0)]


class Backbone(nn.Module):
    def __init__(self, device):
        super().__init__()
        self.body = ResNet50Body(device)
        self.fpn = FPN(device)


class RPNHead(nn.Module):
    def __init__(self, device):
        super().__init__()
        a = len(ANCHOR_RATIOS)
        self.conv = nn.Conv2d(256, 256, 3, 1, 1, device=device)
        self.cls_logits = nn.Conv2d(256, a, 1, device=device)
        self.bbox_pred = nn.Conv2d(256, 4 * a, 1, device=device)

    def forward(self, f):
        t = F.relu(self.conv(f))
        return self.cls_logits(t), self.bbox_pred(t)


class RPN(nn.Module):
    def __init__(self, device):
        super().__init__()
        self.head = RPNHead(device)


class TwoMLPHead(nn.Module):
    def __init__(self, device):
        super().__init__()
        self.fc6 = nn.Linear(256 * 7 * 7, 1024, device=device)
        self.fc7 = nn.Linear(1024, 1024, device=device)

    def forward(self, x):
        return F.relu(self.fc7(F.relu(self.fc6(x.flatten(1)))))


class FastRCNNPredictor(nn.Module):
    def __init__(self, device):
        super().__init__()
        self.cls_score = nn.Linear(1024, NUM_CLASSES, device=device)
        self.bbox_pred = nn.Linear(1024, NUM_CLASSES * 4, device=device)


class RoIHeads(nn.Module):
    def __init__(self, device):
        super().__init__()
        self.box_head = TwoMLPHead(device)
        self.box_predictor = FastRCNNPredictor(device)


_LAYOUTS = [(re.compile(r"(backbone\.fpn\.(?:inner|layer)_blocks\.\d)\.0\."), r"\1."),
            (re.compile(r"(rpn\.head\.conv)\.0\.0\."), r"\1.")]


class MaskRCNN(nn.Module):
    """The weights of torchvision's ``maskrcnn_resnet50_fpn`` detection
    path: ``backbone.body`` (ResNet-50, FrozenBatchNorm), ``backbone.fpn``,
    ``rpn.head``, ``roi_heads.box_head`` / ``box_predictor``."""

    def __init__(self, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.backbone = Backbone(device)
        self.rpn = RPN(device)
        self.roi_heads = RoIHeads(device)
        self._register_load_state_dict_pre_hook(_torchvision_layout)
        self.eval()

    @torch.no_grad()
    def init_weights(self, seed: Union[int, torch.Generator]) -> "MaskRCNN":
        """The JAX package's test init: convs and linears N(0, 0.01), zero
        biases, FrozenBN scale 1 + N(0, 0.1) and shift N(0, 0.1)."""
        gen = make_generator(seed, self.rpn.head.conv.weight.device)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0.0, 0.01, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, FrozenBatchNorm2d):
                m.weight.normal_(1.0, 0.1, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.zero_()
                m.running_var.fill_(1.0 - m.eps)
        return self


def _torchvision_layout(state_dict, prefix, *args):
    """Either torchvision layout -> this module's names; the mask branch
    (never used by the reference filter) dropped."""
    for k in list(state_dict):
        if not k.startswith(prefix):
            continue
        name = k[len(prefix):]
        if name.startswith(("roi_heads.mask_head.", "roi_heads.mask_predictor.")):
            del state_dict[k]
            continue
        for pattern, repl in _LAYOUTS:
            new = pattern.sub(repl, name)
            if new != name:
                state_dict[prefix + new] = state_dict.pop(k)
                break


# --------------------------------------------------------------------------- #
# device stages (NCHW)
# --------------------------------------------------------------------------- #
def backbone_fpn(model: MaskRCNN, images: torch.Tensor) -> List[torch.Tensor]:
    """images [N, 3, H, W] (normalised) -> [P2, P3, P4, P5, P6] NCHW."""
    return model.backbone.fpn(model.backbone.body(images))


def rpn_head(model: MaskRCNN, feats: Sequence[torch.Tensor]):
    """-> per level (objectness [N, A, H, W], deltas [N, 4A, H, W])."""
    return [model.rpn.head(f) for f in feats]


def box_head(model: MaskRCNN, pooled: torch.Tensor):
    """pooled [R, 256, 7, 7] -> (class_logits [R, 91], deltas [R, 364]);
    the flatten is torchvision's CHW."""
    x = model.roi_heads.box_head(pooled)
    pred = model.roi_heads.box_predictor
    return pred.cls_score(x), pred.bbox_pred(x)


def roi_align(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              output_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """torchvision ``roi_align`` (aligned=False) on one feature map, in
    plain torch.  feat [C, H, W]; rois [R, 4] (x1, y1, x2, y2) in image
    coordinates -> [R, C, out, out].  ``sampling_ratio**2`` bilinear points
    per bin, averaged; a point with y < -1 or y > H (resp. x) contributes
    zero but counts in the mean, the others clamp to the border."""
    c, h, w = feat.shape
    n = sampling_ratio
    boxes = rois * spatial_scale
    x1, y1, x2, y2 = boxes.unbind(1)
    bin_w = torch.clamp(x2 - x1, min=1.0) / output_size
    bin_h = torch.clamp(y2 - y1, min=1.0) / output_size
    grid = (torch.arange(output_size, device=feat.device)[None, :, None]
            + (torch.arange(n, device=feat.device)[None, None, :] + 0.5) / n)
    ys = y1[:, None, None] + grid * bin_h[:, None, None]       # [R, out, n]
    xs = x1[:, None, None] + grid * bin_w[:, None, None]

    def sample_axis(v, size):
        valid = (v >= -1.0) & (v <= size)
        v = v.clamp(0.0, size - 1)
        lo = v.floor()
        frac = v - lo
        lo = lo.long()
        return valid, lo, torch.clamp(lo + 1, max=size - 1), frac

    yv, ylo, yhi, yfrac = sample_axis(ys, h)
    xv, xlo, xhi, xfrac = sample_axis(xs, w)
    hwc = feat.permute(1, 2, 0)

    def gather(yi, xi):                   # -> [R, out, n, out, n, C]
        return hwc[yi[:, :, :, None, None], xi[:, None, None, :, :]]

    ya, yb = (1 - yfrac)[:, :, :, None, None], yfrac[:, :, :, None, None]
    xa, xb = (1 - xfrac)[:, None, None, :, :], xfrac[:, None, None, :, :]
    acc = (gather(ylo, xlo) * (ya * xa)[..., None] + gather(ylo, xhi) * (ya * xb)[..., None]
           + gather(yhi, xlo) * (yb * xa)[..., None] + gather(yhi, xhi) * (yb * xb)[..., None])
    valid = (yv[:, :, :, None, None] & xv[:, None, None, :, :])[..., None]
    acc = torch.where(valid, acc, torch.zeros((), device=acc.device))
    return acc.mean(dim=(2, 4)).permute(0, 3, 1, 2)


# --------------------------------------------------------------------------- #
# host glue (numpy, copied from the JAX package)
# --------------------------------------------------------------------------- #
def cell_anchors(sizes=ANCHOR_SIZES, ratios=ANCHOR_RATIOS) -> List[np.ndarray]:
    """torchvision AnchorGenerator.generate_anchors per level (rounded)."""
    out = []
    for s in sizes:
        h_r = np.sqrt(np.asarray(ratios, np.float32))
        w_r = 1.0 / h_r
        ws = (w_r * s)[:, None]
        hs = (h_r * s)[:, None]
        base = np.concatenate([-ws, -hs, ws, hs], axis=1) / 2.0
        out.append(np.round(base))
    return out


def grid_anchors(feat_hw: Sequence[Tuple[int, int]],
                 padded_hw: Tuple[int, int]) -> List[np.ndarray]:
    """Anchors per level, ordered (y, x, cell-anchor) to match the head's
    permute_and_flatten layout; strides divide the padded size."""
    cells = cell_anchors()
    out = []
    for (fh, fw), cell in zip(feat_hw, cells):
        stride_y = padded_hw[0] // fh
        stride_x = padded_hw[1] // fw
        sx = np.arange(fw, dtype=np.float32) * stride_x
        sy = np.arange(fh, dtype=np.float32) * stride_y
        shift_x, shift_y = np.meshgrid(sx, sy)  # [fh, fw]
        shifts = np.stack([shift_x, shift_y, shift_x, shift_y],
                          axis=-1).reshape(-1, 1, 4)
        out.append((shifts + cell[None]).reshape(-1, 4))
    return out


def decode_boxes(deltas: np.ndarray, boxes: np.ndarray,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> np.ndarray:
    """torchvision BoxCoder.decode_single."""
    wx, wy, ww, wh = weights
    widths = boxes[:, 2] - boxes[:, 0]
    heights = boxes[:, 3] - boxes[:, 1]
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights
    dx = deltas[:, 0::4] / wx
    dy = deltas[:, 1::4] / wy
    dw = np.minimum(deltas[:, 2::4] / ww, BBOX_XFORM_CLIP)
    dh = np.minimum(deltas[:, 3::4] / wh, BBOX_XFORM_CLIP)
    pred_ctr_x = dx * widths[:, None] + ctr_x[:, None]
    pred_ctr_y = dy * heights[:, None] + ctr_y[:, None]
    pred_w = np.exp(dw) * widths[:, None]
    pred_h = np.exp(dh) * heights[:, None]
    out = np.empty_like(deltas)
    out[:, 0::4] = pred_ctr_x - 0.5 * pred_w
    out[:, 1::4] = pred_ctr_y - 0.5 * pred_h
    out[:, 2::4] = pred_ctr_x + 0.5 * pred_w
    out[:, 3::4] = pred_ctr_y + 0.5 * pred_h
    return out


def clip_boxes(boxes: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    boxes = boxes.copy()
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, hw[1])
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, hw[0])
    return boxes


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float
        ) -> np.ndarray:
    """Greedy NMS, descending score; returns kept indices."""
    order = np.argsort(-scores, kind="stable")
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1) * (y2 - y1)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / (areas[i] + areas[rest] - inter)
        order = rest[iou <= iou_thresh]
    return np.asarray(keep, np.int64)


def batched_nms(boxes, scores, idxs, iou_thresh):
    """Category-offset trick, exactly torchvision ops.boxes.batched_nms."""
    if len(boxes) == 0:
        return np.empty((0,), np.int64)
    max_coord = boxes.max()
    offsets = idxs.astype(np.float32) * (max_coord + 1)
    return nms(boxes + offsets[:, None], scores, iou_thresh)


def _remove_small(boxes, min_size):
    ws = boxes[:, 2] - boxes[:, 0]
    hs = boxes[:, 3] - boxes[:, 1]
    return (ws >= min_size) & (hs >= min_size)


# --------------------------------------------------------------------------- #
# full detector
# --------------------------------------------------------------------------- #
class MaskRCNNDetector:
    """Inference-only detector with the torchvision decision pipeline.

    ``detect(image)`` takes one uint8/float HWC RGB image (values 0..255
    or 0..1) and returns {"boxes", "labels", "scores"} sorted by
    descending score, like torchvision's output dicts.  ``resize=False``
    skips the min-800/max-1333 resize.  The network runs on ``device``,
    where ``model`` must live; ``last_timing`` holds the device and host
    seconds of the last ``detect``."""

    def __init__(self, model: MaskRCNN, min_size: int = 800,
                 max_size: int = 1333, device="cuda"):
        self.device = check_device(model, device)
        self.model = model
        self.min_size = min_size
        self.max_size = max_size
        self.last_timing: Dict[str, float] = {}

    # ---- torchvision GeneralizedRCNNTransform ---------------------------- #
    def _preprocess(self, image: np.ndarray, resize_image: bool):
        """-> (the padded [3, H', W'] tensor on the device, the resized
        (h, w), the original (h, w)); the JAX order: / 255, normalise,
        resize (linear, no antialiasing: torchvision's F.interpolate), pad
        to stride-32 multiples with zeros."""
        x = torch.as_tensor(np.ascontiguousarray(image)).to(self.device)
        x = x.float() / 255.0 if not x.is_floating_point() else x.float()
        x = x.permute(2, 0, 1)
        mean = torch.as_tensor(IMAGENET_MEAN, device=self.device).view(3, 1, 1)
        std = torch.as_tensor(IMAGENET_STD, device=self.device).view(3, 1, 1)
        x = (x - mean) / std
        orig_hw = tuple(image.shape[:2])
        if resize_image:
            h, w = orig_hw
            scale = min(self.min_size / min(h, w), self.max_size / max(h, w))
            # floor sizing: F.interpolate(scale_factor=...,
            # recompute_scale_factor=True) produces floor(in * scale)
            x = resize(x, (int(h * scale), int(w * scale)), "linear", antialias=False)
        h, w = x.shape[1:]
        ph, pw = -(-h // 32) * 32, -(-w // 32) * 32
        x = F.pad(x, (0, pw - w, 0, ph - h))
        return x, (h, w), orig_hw

    def _proposals(self, levels, image_hw, padded_hw):
        """torchvision RegionProposalNetwork.filter_proposals (host)."""
        feat_hw = [tuple(o.shape[2:]) for o, _ in levels]
        anchors = grid_anchors(feat_hw, padded_hw)
        all_boxes, all_scores, all_lvl = [], [], []
        for lvl, ((obj, deltas), anc) in enumerate(zip(levels, anchors)):
            # (y, x, anchor) flatten: torchvision's permute_and_flatten
            obj = obj[0].permute(1, 2, 0).reshape(-1).cpu().numpy()
            dl = (deltas[0].view(len(ANCHOR_RATIOS), 4, *deltas.shape[2:]).permute(2, 3, 0, 1)
                  .reshape(-1, 4).cpu().numpy())
            k = min(RPN_PRE_NMS_TOP_N, obj.shape[0])
            top = np.argpartition(-obj, k - 1)[:k]
            top = top[np.argsort(-obj[top], kind="stable")]
            boxes = decode_boxes(dl[top], anc[top]).reshape(-1, 4)
            all_boxes.append(boxes)
            all_scores.append(obj[top])
            all_lvl.append(np.full(k, lvl, np.int64))
        boxes = np.concatenate(all_boxes)
        scores = 1.0 / (1.0 + np.exp(-np.concatenate(all_scores)))
        lvls = np.concatenate(all_lvl)
        boxes = clip_boxes(boxes, image_hw)
        keep = _remove_small(boxes, RPN_MIN_SIZE) & (scores >= RPN_SCORE_THRESH)
        boxes, scores, lvls = boxes[keep], scores[keep], lvls[keep]
        keep = batched_nms(boxes, scores, lvls, RPN_NMS_THRESH)
        keep = keep[:RPN_POST_NMS_TOP_N]
        return boxes[keep]

    def _pool(self, feats, proposals) -> torch.Tensor:
        """MultiScaleRoIAlign over P2..P5 with the canonical level mapper
        (k0 = 4, canonical 224, levels clamped to [2, 5]) -> [R, 256, 7, 7]
        on the device."""
        areas = ((proposals[:, 2] - proposals[:, 0])
                 * (proposals[:, 3] - proposals[:, 1]))
        k = np.floor(4 + np.log2(np.sqrt(np.maximum(areas, 0)) / 224 + 1e-6))
        k = np.clip(k, 2, 5).astype(np.int64) - 2
        pooled = torch.zeros(len(proposals), 256, 7, 7, device=self.device)
        for lvl in range(4):
            sel = np.nonzero(k == lvl)[0]
            if not len(sel):
                continue
            rois = torch.from_numpy(np.ascontiguousarray(
                proposals[sel], np.float32)).to(self.device)
            pooled[torch.from_numpy(sel).to(self.device)] = roi_align(
                feats[lvl][0], rois, 1.0 / FPN_STRIDES[lvl], 7, 2)
        return pooled

    def detect(self, image: np.ndarray, resize: bool = True) -> Dict:
        import time
        t0 = time.perf_counter()
        with torch.inference_mode():
            # device: the preprocessing, the network and the copies back
            img, image_hw, orig_hw = self._preprocess(image, resize)
            feats = backbone_fpn(self.model, img[None])
            levels = [(o.cpu(), d.cpu()) for o, d in rpn_head(self.model, feats)]
            device_s = time.perf_counter() - t0
            proposals = self._proposals(levels, image_hw, tuple(img.shape[1:]))
            if len(proposals) == 0:
                self.last_timing = {"device_s": device_s,
                                    "host_s": time.perf_counter() - t0 - device_s}
                return {"boxes": np.zeros((0, 4), np.float32),
                        "labels": np.zeros((0,), np.int64),
                        "scores": np.zeros((0,), np.float32)}
            t1 = time.perf_counter()
            pooled = self._pool(feats, proposals)
            cls_logits, box_deltas = box_head(self.model, pooled)
            cls_logits = cls_logits.cpu().numpy()
            box_deltas = box_deltas.cpu().numpy()
            device_s += time.perf_counter() - t1

        # torchvision RoIHeads.postprocess_detections
        scores = np.exp(cls_logits - cls_logits.max(-1, keepdims=True))
        scores = scores / scores.sum(-1, keepdims=True)
        boxes = decode_boxes(box_deltas, proposals,
                             weights=(10.0, 10.0, 5.0, 5.0))
        boxes = boxes.reshape(-1, NUM_CLASSES, 4)
        boxes = clip_boxes(boxes.reshape(-1, 4), image_hw).reshape(
            -1, NUM_CLASSES, 4)

        out_boxes, out_scores, out_labels = [], [], []
        for c in range(1, NUM_CLASSES):  # skip background
            sc = scores[:, c]
            sel = sc > BOX_SCORE_THRESH
            bx = boxes[sel, c]
            sc = sc[sel]
            ok = _remove_small(bx, 1e-2)
            bx, sc = bx[ok], sc[ok]
            out_boxes.append(bx)
            out_scores.append(sc)
            out_labels.append(np.full(len(sc), c, np.int64))
        boxes = np.concatenate(out_boxes)
        scores = np.concatenate(out_scores)
        labels = np.concatenate(out_labels)
        keep = batched_nms(boxes, scores, labels, BOX_NMS_THRESH)
        keep = keep[:DETECTIONS_PER_IMG]
        boxes = boxes[keep].astype(np.float32)
        if image_hw != orig_hw:
            # transform.postprocess: boxes back to ORIGINAL image coords
            boxes = boxes * np.asarray(
                [orig_hw[1] / image_hw[1], orig_hw[0] / image_hw[0]] * 2,
                np.float32)
        self.last_timing = {"device_s": device_s,
                            "host_s": time.perf_counter() - t0 - device_s}
        return {"boxes": boxes,
                "labels": labels[keep],
                "scores": scores[keep].astype(np.float32)}

    def classify_person(self, image: np.ndarray, resize: bool = True) -> bool:
        """Reference ``classify_person``: a person among the top-5
        detections."""
        det = self.detect(image, resize=resize)
        return PERSON_LABEL in det["labels"][:5]


def person_flags_for_frames(detector: MaskRCNNDetector,
                            frames: Sequence[np.ndarray]) -> List[bool]:
    """Batch driver for ``filters.filter_frames``' person flags."""
    return [detector.classify_person(f) for f in frames]
