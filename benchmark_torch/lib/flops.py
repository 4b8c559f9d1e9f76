"""Operations and bytes of the two-head ResNet, from its shapes alone.

A configuration (``configs/<name>.json``) gives the geometry: the stem
width, ``stage_sizes``, the bottleneck's ``base_width`` and ``groups``,
``fc_layer_dim``, ``n_classes`` and ``image_size``.  :func:`convs` lists
every convolution of one image's forward with its input and output sizes;
:func:`forward_macs` adds the two dense heads.  A multiply-add is one MAC
and two FLOPs.  Bytes count each input read once and each output written
once, in the compute dtype (bf16, 2 bytes), the weights too, since the
port casts each kernel to the compute dtype before its conv.
"""

from __future__ import annotations

from typing import List, NamedTuple


class ConvShape(NamedTuple):
    name: str
    cin: int
    cout: int
    k: int
    stride: int
    groups: int
    h_in: int
    h_out: int

    @property
    def macs(self) -> int:
        """Multiply-adds of one image."""
        return self.h_out * self.h_out * self.cout * (
            self.cin // self.groups) * self.k * self.k

    def weight_elems(self) -> int:
        return self.cout * (self.cin // self.groups) * self.k * self.k


def _out(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def convs(cfg: dict) -> List[ConvShape]:
    """Every convolution of one forward, in order (stem, then each
    bottleneck's conv1, conv2, conv3 and downsample)."""
    h = int(cfg["image_size"])
    width = int(cfg.get("width", 64))
    base_width = int(cfg.get("base_width", 64))
    groups = int(cfg.get("groups", 1))
    out = []
    h1 = _out(h, 7, 2, 3)
    out.append(ConvShape("resnet_base.conv1", 3, width, 7, 2, 1, h, h1))
    h = _out(h1, 3, 2, 1)  # max pool 3/2, padding 1
    cin = width
    for i, count in enumerate(cfg["stage_sizes"]):
        filters = width * 2 ** i
        inner = int(filters * (base_width / 64.0)) * groups
        expand = filters * 4
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            p = f"resnet_base.layer{i + 1}.{j}"
            h2 = _out(h, 3, stride, 1)
            out.append(ConvShape(f"{p}.conv1", cin, inner, 1, 1, 1, h, h))
            out.append(ConvShape(f"{p}.conv2", inner, inner, 3, stride,
                                 groups, h, h2))
            out.append(ConvShape(f"{p}.conv3", inner, expand, 1, 1, 1, h2,
                                 h2))
            if stride != 1 or cin != expand:
                out.append(ConvShape(f"{p}.downsample.0", cin, expand, 1,
                                     stride, 1, h, _out(h, 1, stride, 0)))
            cin, h = expand, h2
    return out


def final_channels(cfg: dict) -> int:
    return int(cfg.get("width", 64)) * 2 ** (len(cfg["stage_sizes"]) - 1) * 4


def dense_macs(cfg: dict) -> int:
    """The features head (``final channels -> fc_layer_dim``) and the
    logits head (``fc_layer_dim -> n_classes``), one image."""
    fc = int(cfg["fc_layer_dim"])
    return final_channels(cfg) * fc + fc * int(cfg["n_classes"])


def forward_macs(cfg: dict) -> int:
    """Multiply-adds of one image's forward (convolutions and both dense
    heads; batch-norm, ReLU, pooling and the residual adds are not
    counted, as in the published figures)."""
    return sum(c.macs for c in convs(cfg)) + dense_macs(cfg)


def forward_flops(cfg: dict) -> float:
    return 2.0 * forward_macs(cfg)


def train_flops(cfg: dict) -> float:
    """A training image: the forward and the two products of the backward
    (data and weight gradients), 3x the forward."""
    return 3.0 * forward_flops(cfg)


def product_step_bound_ms(cfg: dict, batch: int, card) -> float:
    """The least milliseconds of every product of one train step of
    ``batch`` images: each convolution's and each dense head's forward,
    data gradient (not the stem's: the images need none) and weight
    gradient, each bounded by the larger of its FLOPs at the bf16 peak and
    its bytes at the memory rate (2 bytes an element; each input read
    once, each output written once)."""
    shapes = [(c.name, batch * c.cin * c.h_in * c.h_in,
               batch * c.cout * c.h_out * c.h_out, c.weight_elems(),
               2.0 * batch * c.macs) for c in convs(cfg)]
    fc, n_cls = int(cfg["fc_layer_dim"]), int(cfg["n_classes"])
    final = final_channels(cfg)
    shapes.append(("resnet_base.fc", batch * final, batch * fc, final * fc,
                   2.0 * batch * final * fc))
    shapes.append(("logits", batch * fc, batch * n_cls, fc * n_cls,
                   2.0 * batch * fc * n_cls))
    total = 0.0
    for name, x, y, w, flops in shapes:
        passes = [x + w + y,   # forward: read x, w; write y
                  x + y + w]   # weight gradient: read x, dy; write dw
        if name != "resnet_base.conv1":
            passes.append(y + w + x)  # data gradient: read dy, w; write dx
        for elems in passes:
            total += card.bound_ms(2.0 * elems, flops)[0]
    return total


def loss_kernel_bytes(batch: int, n_classes: int) -> float:
    """Bytes of the entropic loss's two kernels on float32 logits: K1
    reads the logits, int32 labels and the float32 row mask (and writes
    three floats); K2 reads the same and writes the logits' gradient."""
    logits = 4.0 * batch * n_classes
    rows = 8.0 * batch
    return (logits + rows + 12) + (2 * logits + rows + 4)
