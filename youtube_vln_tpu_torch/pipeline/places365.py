"""Steps 5a and 5b's scene classifiers in PyTorch (counterpart of
``youtube_vln_tpu/pipeline/places365.py``).

  * ``WideResNet18``: the reference's vendored Places365 ResNet-18
    (``scripts/video_process/wideresnet.py``: no maxpool after conv1, a
    14x14 final map at 224 input, 365 classes), BatchNorm in eval mode.
    ``places_forward`` returns the logits and the two tensors the reference
    hooks (``layer4`` and the pooled feature); ``resnet18_backbone_forward``
    is the torchvision ResNet-18 trunk (with the maxpool) that the
    inverse-action model encodes frames with.
  * ``AlexNet``: torchvision's AlexNet with 365 classes, the person
    filter's indoor scorer.

Both are NCHW modules under torchvision's key names, so a torchvision or
Places365 ``state_dict()`` loads with ``strict=True`` (a ``module.``
prefix is stripped).  The preprocessors take uint8 ``[N, H, W, 3]`` frames
and return normalised NCHW float32 tensors on the device, resized as
``jax.image.resize`` resizes (``resize.py``).  Every constructor and
driver takes ``device``, CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import check_device, make_generator, resolve_device
from .resize import resize as resize_image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def strip_module_prefix(module: nn.Module) -> None:
    """Loads a DataParallel checkpoint (``module.``-prefixed keys) into
    ``module`` as it is."""
    def hook(state_dict, prefix, *args):
        for k in [k for k in state_dict if k.startswith(prefix + "module.")]:
            state_dict[prefix + k[len(prefix) + 7:]] = state_dict.pop(k)
    module._register_load_state_dict_pre_hook(hook)


# --------------------------------------------------------------------------- #
# WideResNet-18 (Places365) and the ResNet-18 trunk
# --------------------------------------------------------------------------- #
class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, device):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(planes, device=device)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False, device=device)
        self.bn2 = nn.BatchNorm2d(planes, device=device)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes, 1, stride, bias=False, device=device),
                nn.BatchNorm2d(planes, device=device))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(h + r)


class WideResNet18(nn.Module):
    """The Places365 WideResNet-18 (ResNet-18 blocks, 365 classes) in eval
    mode; ``init_weights`` draws the reference's init (conv weights N(0,
    sqrt(2 / (kh kw cout))), BN at identity, fc N(0, 0.01))."""

    def __init__(self, num_classes: int = 365,
                 blocks: Sequence[int] = (2, 2, 2, 2), device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False, device=device)
        self.bn1 = nn.BatchNorm2d(64, device=device)
        cin = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), blocks)):
            layer = []
            for bi in range(n):
                stride = 2 if (li > 0 and bi == 0) else 1
                layer.append(BasicBlock(cin, planes, stride, device))
                cin = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
        self.fc = nn.Linear(512, num_classes, device=device)
        strip_module_prefix(self)
        self.eval()

    @torch.no_grad()
    def init_weights(self, seed: Union[int, torch.Generator]) -> "WideResNet18":
        gen = make_generator(seed, self.fc.weight.device)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                cout, _, kh, kw = m.weight.shape
                m.weight.normal_(0.0, (2.0 / (kh * kw * cout)) ** 0.5, generator=gen)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        self.fc.weight.normal_(0.0, 0.01, generator=gen)
        self.fc.bias.zero_()
        return self

    def trunk(self, x, maxpool: bool):
        x = F.relu(self.bn1(self.conv1(x)))
        if maxpool:
            x = F.max_pool2d(x, 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))

    def forward(self, x):
        return places_forward(self, x)


def places_forward(model: WideResNet18, images: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """images [N, 3, H, W] (normalised) -> (logits [N, C], layer4 [N, 512,
    h, w], pooled [N, 512]); no maxpool (the vendored variant), the pool a
    global mean (AvgPool2d(14) at 224 input)."""
    layer4 = model.trunk(images, maxpool=False)
    pooled = layer4.mean(dim=(2, 3))
    return model.fc(pooled), layer4, pooled


def resnet18_backbone_forward(model: WideResNet18, images: torch.Tensor, *,
                              maxpool: bool = True) -> torch.Tensor:
    """The torchvision ResNet-18 trunk up to layer4 (``children()[:-2]``,
    [N, 512, 7, 7] at 224 input); ``maxpool=False`` is the Places365
    variant's trunk."""
    return model.trunk(images, maxpool)


def frames_to_device(images_uint8, device) -> torch.Tensor:
    """uint8 [N, H, W, 3] frames -> float32 [N, 3, H, W] / 255 on ``device``."""
    x = torch.as_tensor(np.ascontiguousarray(images_uint8)).to(device)
    return x.permute(0, 3, 1, 2).float() / 255.0


def normalize(x, mean, std):
    m = torch.as_tensor(mean, device=x.device).view(1, 3, 1, 1)
    s = torch.as_tensor(std, device=x.device).view(1, 3, 1, 1)
    return (x - m) / s


def preprocess_images(images_uint8: np.ndarray, size: int = 224,
                      device="cuda") -> torch.Tensor:
    """[N, H, W, 3] uint8 -> [N, 3, size, size] float32 on ``device``: the
    whole frame resized (bilinear, antialiased) and ImageNet-normalised,
    the reference's Resize(224) / ToTensor / Normalize."""
    x = frames_to_device(images_uint8, resolve_device(device))
    x = resize_image(x, (size, size), "bilinear", antialias=True)
    return normalize(x, IMAGENET_MEAN, IMAGENET_STD)


def crop_size(h: int, w: int, resize_to: int, crop: int) -> Tuple[int, int]:
    """The size that Resize(resize_to) gives the shorter side (aspect kept),
    as the JAX preprocessors compute it."""
    if h < w:
        return resize_to, max(crop, int(round(w * resize_to / h)))
    return max(crop, int(round(h * resize_to / w))), resize_to


def preprocess_images_crop(images_uint8: np.ndarray, resize: int = 256,
                           crop: int = 224, device="cuda") -> torch.Tensor:
    """Resize(256) on the shorter side + CenterCrop(224) + ImageNet
    normalisation (the person filter's transform), NCHW on ``device``."""
    x = frames_to_device(images_uint8, resolve_device(device))
    nh, nw = crop_size(x.shape[2], x.shape[3], resize, crop)
    x = resize_image(x, (nh, nw), "bilinear", antialias=True)
    top, left = (nh - crop) // 2, (nw - crop) // 2
    x = x[:, :, top:top + crop, left:left + crop]
    return normalize(x, IMAGENET_MEAN, IMAGENET_STD)


# --------------------------------------------------------------------------- #
# AlexNet (Places365)
# --------------------------------------------------------------------------- #
class AlexNet(nn.Module):
    """torchvision's AlexNet (``features.{0,3,6,8,10}`` convs,
    ``classifier.{1,4,6}`` linears), in eval mode."""

    def __init__(self, num_classes: int = 365, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        conv = lambda cin, cout, k, s, p: nn.Conv2d(cin, cout, k, s, p, device=device)
        self.features = nn.Sequential(
            conv(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            conv(64, 192, 5, 1, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            conv(192, 384, 3, 1, 1), nn.ReLU(),
            conv(384, 256, 3, 1, 1), nn.ReLU(),
            conv(256, 256, 3, 1, 1), nn.ReLU(), nn.MaxPool2d(3, 2))
        self.classifier = nn.Sequential(
            nn.Dropout(), nn.Linear(256 * 6 * 6, 4096, device=device), nn.ReLU(),
            nn.Dropout(), nn.Linear(4096, 4096, device=device), nn.ReLU(),
            nn.Linear(4096, num_classes, device=device))
        strip_module_prefix(self)
        self.eval()

    @torch.no_grad()
    def init_weights(self, seed: Union[int, torch.Generator]) -> "AlexNet":
        """The JAX package's init: convs as the WideResNet's, linears N(0,
        0.01), zero biases."""
        gen = make_generator(seed, self.features[0].weight.device)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                cout, _, kh, kw = m.weight.shape
                m.weight.normal_(0.0, (2.0 / (kh * kw * cout)) ** 0.5, generator=gen)
            elif isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.01, generator=gen)
            else:
                continue
            m.bias.zero_()
        return self

    def forward(self, x):
        x = F.adaptive_avg_pool2d(self.features(x), (6, 6))
        return self.classifier(torch.flatten(x, 1))


def alexnet_indoor_probs(model: AlexNet, images_uint8: np.ndarray,
                         is_indoor_class: np.ndarray, batch_size: int = 64,
                         top_k: int = 10, device="cuda") -> np.ndarray:
    """The reference's ``classify_indoors``: per frame, the summed softmax
    probability of the indoor scene categories among the top-k classes."""
    from .filters import indoor_probability

    dev = check_device(model, device)
    out: List[float] = []
    for s in range(0, len(images_uint8), batch_size):
        imgs = preprocess_images_crop(images_uint8[s:s + batch_size], device=dev)
        with torch.inference_mode():
            probs = torch.softmax(model(imgs), dim=-1).cpu().numpy()
        out += [indoor_probability(p, is_indoor_class, top_k=top_k) for p in probs]
    return np.asarray(out, np.float32)


# --------------------------------------------------------------------------- #
# scoring (the reference's run_model)
# --------------------------------------------------------------------------- #
def is_indoor(sorted_idx: np.ndarray, labels_io: np.ndarray) -> Tuple[float, bool]:
    """Vote over the top-10 scene categories."""
    io_image = float(np.mean(labels_io[sorted_idx[:10]]))
    return io_image, bool(io_image < 0.5)


def score_batch(model: WideResNet18, images: torch.Tensor, *,
                labels_io: np.ndarray,
                classes: Optional[Sequence[str]] = None,
                labels_attribute: Optional[Sequence[str]] = None,
                w_attribute: Optional[np.ndarray] = None,
                num_cat: int = 5, num_attr: int = 10,
                device="cuda") -> List[Dict]:
    """The reference's ``run_model``: per preprocessed image, the scene
    top-k, the attribute responses of the pooled feature, the indoor
    vote."""
    dev = check_device(model, device)
    with torch.inference_mode():
        logits, _, pooled = places_forward(model, images.to(dev))
        probs = torch.softmax(logits, dim=-1).cpu().numpy()
        pooled = pooled.cpu().numpy()
    out = []
    for i in range(probs.shape[0]):
        idx = np.argsort(-probs[i])
        det: Dict = {"is_indoor": is_indoor(idx, labels_io)}
        if classes is not None:
            det["category"] = [(float(probs[i, idx[j]]), classes[idx[j]])
                               for j in range(num_cat)]
        if w_attribute is not None and labels_attribute is not None:
            resp = w_attribute.dot(pooled[i])
            resp = np.exp(resp - resp.max())
            resp /= resp.sum()
            idx_a = np.argsort(resp)
            det["attributes"] = [(float(resp[idx_a[j]]), labels_attribute[idx_a[j]])
                                 for j in range(-1, -num_attr, -1)]
        out.append(det)
    return out


def indoor_scores(model: WideResNet18, images_uint8: np.ndarray,
                  labels_io: np.ndarray, batch_size: int = 64,
                  device="cuda") -> np.ndarray:
    """1 - mean(labels_IO[top10]) per frame: the input of
    ``filters.indoor_filter`` (threshold 0.5 is the reference's vote)."""
    dev = check_device(model, device)
    scores = []
    for s in range(0, len(images_uint8), batch_size):
        imgs = preprocess_images(images_uint8[s:s + batch_size], device=dev)
        for det in score_batch(model, imgs, labels_io=labels_io, device=dev):
            scores.append(1.0 - det["is_indoor"][0])
    return np.asarray(scores, np.float32)
