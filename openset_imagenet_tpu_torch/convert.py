"""Weight bridge between the JAX package's variables and this port's models.

Counterpart of :mod:`openset_imagenet_tpu.convert`, without jax: it works
on nested dicts of numpy arrays (``{"params": ..., "batch_stats": ...}``
as ``jax.device_get`` returns them) and on ``state_dict``-style mappings.

Key mapping (flax path -> torch key), as ``convert._torch_key``:
  conv_init/kernel                  resnet_base.conv1.weight  (HWIO->OIHW)
  bn_init.{scale,bias,mean,var}     resnet_base.bn1.{weight,bias,running_*}
  stage{i}_block{j}/Conv_{k}        resnet_base.layer{i}.{j-1}.conv{k+1}
  stage{i}_block{j}/bn{k}           resnet_base.layer{i}.{j-1}.bn{k}
  .../downsample_conv, downsample_bn  ....downsample.0 / .1
  fc/{kernel,bias}                  resnet_base.fc.*    ([in,out]->[out,in])
  logits/{kernel,bias}              logits.*

The folded graph's conv biases (``conv_init/bias``, ``.../Conv_{k}/bias``)
map to the conv's ``bias``; the quantized graph's leaves ``scale``,
``bias`` and ``inv_input_scale`` keep their names on the ``QuantConv``,
and its int8 ``kernel`` goes HWIO -> ``[Cout, kh, kw, Cin/groups]`` (the
kernel's layout) as int8.

:func:`load_opt_state` carries an optax optimizer state across with the
same mapping: Adam's ``ScaleByAdamState(count, mu, nu)`` becomes each
parameter's ``step`` / ``exp_avg`` / ``exp_avg_sq`` in ``torch.optim.Adam``,
SGD's ``TraceState(trace)`` its ``momentum_buffer`` in ``torch.optim.SGD``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

_BN_STAT = {"scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}
_BN_LEAF = {v: k for k, v in _BN_STAT.items()}
_BATCH_STATS = ("mean", "var")
# A conv's leaves: the kernel, the folded graph's bias and QuantConv's.
_CONV_LEAF = {"kernel": "weight", "bias": "bias", "scale": "scale",
              "inv_input_scale": "inv_input_scale"}
_CONV_PARAM = {v: k for k, v in _CONV_LEAF.items()}


def strip_module_prefix(state_dict: Mapping[str, object]) -> dict:
    """Remove a DDP ``module.`` prefix (reference ``train.py:80-87``)."""
    if state_dict and next(iter(state_dict)).startswith("module."):
        return {k[len("module."):]: v for k, v in state_dict.items()}
    return dict(state_dict)


def torch_key(flax_path: Tuple[str, ...]) -> str:
    """Torch ``state_dict`` key for one flax variable path."""
    parts = list(flax_path)
    leaf = parts[-1]
    if parts[0] == "conv_init":
        return f"resnet_base.conv1.{_CONV_LEAF[leaf]}"
    if parts[0] == "bn_init":
        return f"resnet_base.bn1.{_BN_STAT[leaf]}"
    if parts[0] in ("fc", "logits"):
        prefix = "resnet_base.fc" if parts[0] == "fc" else "logits"
        return f"{prefix}.{'weight' if leaf == 'kernel' else 'bias'}"
    m = re.fullmatch(r"stage(\d+)_block(\d+)", parts[0])
    if m:
        stage, block = int(m.group(1)), int(m.group(2)) - 1
        mod = parts[1]
        if mod.startswith("Conv_"):
            sub = f"conv{int(mod[5:]) + 1}.{_CONV_LEAF[leaf]}"
        elif mod == "downsample_conv":
            sub = f"downsample.0.{_CONV_LEAF[leaf]}"
        elif mod == "downsample_bn":
            sub = f"downsample.1.{_BN_STAT[leaf]}"
        elif mod.startswith("bn"):
            sub = f"{mod}.{_BN_STAT[leaf]}"
        else:
            raise KeyError(f"unmapped flax module {flax_path}")
        return f"resnet_base.layer{stage}.{block}.{sub}"
    raise KeyError(f"unmapped flax path {flax_path}")


def flax_path(key: str) -> Tuple[str, ...]:
    """Inverse of :func:`torch_key`."""
    m = re.fullmatch(r"resnet_base\.conv1\.(\w+)", key)
    if m:
        return ("conv_init", _CONV_PARAM[m.group(1)])
    m = re.fullmatch(r"resnet_base\.bn1\.(\w+)", key)
    if m:
        return ("bn_init", _BN_LEAF[m.group(1)])
    m = re.fullmatch(r"(resnet_base\.fc|logits)\.(weight|bias)", key)
    if m:
        head = "fc" if m.group(1) == "resnet_base.fc" else "logits"
        return (head, "kernel" if m.group(2) == "weight" else "bias")
    m = re.fullmatch(r"resnet_base\.layer(\d+)\.(\d+)\.(.+)", key)
    if m:
        block = f"stage{m.group(1)}_block{int(m.group(2)) + 1}"
        sub = m.group(3)
        c = re.fullmatch(r"conv(\d+)\.(\w+)", sub)
        if c:
            return (block, f"Conv_{int(c.group(1)) - 1}",
                    _CONV_PARAM[c.group(2)])
        c = re.fullmatch(r"downsample\.0\.(\w+)", sub)
        if c:
            return (block, "downsample_conv", _CONV_PARAM[c.group(1)])
        d = re.fullmatch(r"downsample\.1\.(\w+)", sub)
        if d:
            return (block, "downsample_bn", _BN_LEAF[d.group(1)])
        b = re.fullmatch(r"(bn\d+)\.(\w+)", sub)
        if b:
            return (block, b.group(1), _BN_LEAF[b.group(2)])
    raise KeyError(f"unmapped torch key {key!r}")


def _walk(tree, prefix=()):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def variables_to_state_dict(variables) -> Dict[str, np.ndarray]:
    """flax ``{"params", "batch_stats"}`` (numpy leaves) -> torch keys.

    Kernels are transposed (HWIO -> OIHW, ``[in, out]`` -> ``[out, in]``;
    a quantized graph's int8 HWIO kernel -> ``[Cout, kh, kw, Cin/groups]``);
    values come back as contiguous numpy arrays, int8 kernels as int8 and
    everything else as float32.
    """
    out: Dict[str, np.ndarray] = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(coll, {})):
            t = np.asarray(leaf)
            t = t if t.dtype == np.int8 else t.astype(np.float32,
                                                       copy=False)
            if path[-1] == "kernel":
                if t.ndim == 4:
                    order = (3, 0, 1, 2) if t.dtype == np.int8 else \
                        (3, 2, 0, 1)
                    t = np.transpose(t, order)
                else:
                    t = np.transpose(t, (1, 0))
            out[torch_key(path)] = np.asarray(t, order="C")
    return out


def state_dict_to_variables(state_dict) -> dict:
    """Torch-keyed arrays -> flax ``{"params", "batch_stats"}`` numpy tree.

    Accepts torch tensors or numpy arrays and a DDP ``module.`` prefix;
    ``num_batches_tracked`` entries (torch BN bookkeeping) are skipped.
    """
    variables = {"params": {}, "batch_stats": {}}
    for key, value in strip_module_prefix(state_dict).items():
        if key.endswith("num_batches_tracked"):
            continue
        t = _to_numpy(value)
        path = flax_path(key)
        if path[-1] == "kernel":
            if t.ndim == 4:
                order = (1, 2, 3, 0) if t.dtype == np.int8 else (2, 3, 1, 0)
                t = np.transpose(t, order)
            else:
                t = np.transpose(t, (1, 0))
        coll = "batch_stats" if path[-1] in _BATCH_STATS else "params"
        node = variables[coll]
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.asarray(t, order="C")
    return variables


def _to_numpy(value) -> np.ndarray:
    """A float32 numpy array (int8 stays int8: a quantized kernel)."""
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    value = np.asarray(value)
    return value if value.dtype == np.int8 else value.astype(np.float32,
                                                             copy=False)


def load_into(model, state_dict) -> None:
    """Copy a reference-layout ``state_dict`` into ``model`` in place.

    Every key of the model must be present with the same shape: a missing
    key raises ``KeyError`` and a shape mismatch ``ValueError``, as the
    JAX bridge does (``convert.py:109-117``).  Extra keys (e.g. torch's
    ``num_batches_tracked``) are ignored.
    """
    import torch

    source = strip_module_prefix(state_dict)
    with torch.no_grad():
        for key, target in model.state_dict(keep_vars=True).items():
            if key not in source:
                raise KeyError(f"checkpoint is missing {key}")
            value = source[key]
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(_to_numpy(value))
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{key}: shape {tuple(value.shape)} != "
                                 f"expected {tuple(target.shape)}")
            target.copy_(value)


def _fields(node) -> Optional[dict]:
    """A state node's fields: mappings, NamedTuples and tuples."""
    if isinstance(node, Mapping):
        return dict(node)
    if hasattr(node, "_asdict"):
        return node._asdict()
    if isinstance(node, (tuple, list)):
        return {str(i): v for i, v in enumerate(node)}
    return None


def _find_state(tree, names: Tuple[str, ...]) -> Optional[dict]:
    """The first sub-state (depth first) that has every field in
    ``names``."""
    fields = _fields(tree)
    if fields is None:
        return None
    if all(n in fields for n in names):
        return fields
    for child in fields.values():
        found = _find_state(child, names)
        if found is not None:
            return found
    return None


def load_opt_state(optimizer, model, opt_state) -> None:
    """Carry an optax Adam or SGD(momentum) state into ``optimizer``.

    ``opt_state`` is the JAX ``TrainState.opt_state`` as numpy leaves
    (``jax.device_get``), either as optax's tuple of NamedTuples or as
    the ``{"0": {...}, ...}`` state dict of a JAX checkpoint.  Moments are
    mapped and transposed like the parameters.  The update count that the
    learning-rate schedule reads is ``TrainState.step``, set by the
    caller.
    """
    import torch

    params = dict(model.named_parameters())

    def per_param(tree) -> Dict[str, np.ndarray]:
        out = variables_to_state_dict({"params": tree})
        if set(out) != set(params):
            raise KeyError(f"optimizer state covers {sorted(set(out))[:3]}"
                           f"..., the model {sorted(params)[:3]}...")
        return out

    def tensor(a, like):
        return torch.from_numpy(a).to(like.device, like.dtype)

    adam = _find_state(opt_state, ("count", "mu", "nu"))
    if isinstance(optimizer, torch.optim.Adam):
        if adam is None:
            raise ValueError("no ScaleByAdamState in the optax state")
        count = float(np.asarray(adam["count"]))
        mu, nu = per_param(adam["mu"]), per_param(adam["nu"])
        for key, p in params.items():
            optimizer.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": tensor(mu[key], p),
                "exp_avg_sq": tensor(nu[key], p)}
        return
    if isinstance(optimizer, torch.optim.SGD):
        trace = _find_state(opt_state, ("trace",))
        if trace is None:
            raise ValueError("no TraceState in the optax state")
        buf = per_param(trace["trace"])
        for key, p in params.items():
            optimizer.state[p] = {"momentum_buffer": tensor(buf[key], p)}
        return
    raise TypeError(f"cannot carry optax state into {type(optimizer)}")
