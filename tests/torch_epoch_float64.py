"""How far the port's ``train_epoch`` lands from the JAX package's, in
float32 and in float64, on image sets of one's choosing (CPU).

    JAX_PLATFORMS=cpu python -m tests.torch_epoch_float64 \
        --loss entropic --roots imagenet set0 set1 set2

Each root runs the comparison of ``tests/test_torch_epoch.py::
test_train_epoch_matches_jax`` (tiny50, 64 px, 21 rows at batch 8, SGD at
lr 1e-3 from shared weights, both pipelines and the ragged-tail step).
The synthetic reader keys every image by its path, so each root is
another image set; the test itself is rooted at ``imagenet``.  The run is
made twice, in float32 and in float64, the second in a child process.

In float64 both packages compute in float64 within that process only:
jax's x64 mode is on, and every ``jnp.float32``, ``torch.float32`` and
``Tensor.float()`` the two packages name at run time stands for float64
(their files are not changed).  The child starts from the float32 run's
initial weights (jax's initializers draw other numbers in float64), and
the images are the same in both runs.

One JSON line per root: for the float32 and the float64 run, the largest
``|port - JAX|`` over the parameters and batch statistics after the
epoch, the key where it falls, and the largest ratio to the test's bound
``1e-4 + 1e-4 * |JAX|`` (above 1 the test would fail); and how far each
package's float32 run lies from its float64 run.  If the two packages
agree in float64 far inside the bound, float32 rounding alone explains a
float32 gap.
"""

import argparse
import json
import pathlib
import pickle
import subprocess
import sys
import tempfile

import numpy as np

TOL = 1e-4
# The test modules import their helpers as the suite's conftest lets them.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))


def _float64():
    """Make float32 stand for float64 in this process (see the module
    docstring)."""
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    torch.set_default_dtype(torch.float64)
    torch.float32 = torch.float64
    torch.Tensor.float = torch.Tensor.double


def _epochs(loss, root, dtype_name, initial=None):
    """Both packages' state dicts after one epoch on the index rooted at
    ``root``, as float64 numpy arrays keyed by the port's names, and the
    initial JAX variables; ``initial`` replaces the test's random draw."""
    import torch
    from collections import defaultdict

    from openset_imagenet_tpu_torch import convert
    from openset_imagenet_tpu_torch import dataset as pdataset
    from openset_imagenet_tpu_torch import pipeline as ppipeline
    from openset_imagenet_tpu_torch import train as pengine
    from openset_imagenet_tpu_torch.config import NameSpace
    from openset_imagenet_tpu_torch.ops.losses import AverageMeter
    from tests import test_torch_epoch as te

    te.ROOT = root
    if initial is not None:
        te._random_variables = lambda model, seed: initial
    with tempfile.TemporaryDirectory() as tmp:
        csv = te._index(pathlib.Path(tmp))
        variables, _, ref = te._jax_epoch(csv, loss)
        ds, n, weights = te._dataset(pdataset, csv, loss)
        dtype = torch.float64 if dtype_name == "float64" else torch.float32
        cfg = NameSpace({"model": {"variant": "tiny50",
                                   "bn_stats_rows": te.GHOST[loss]}})
        model = pengine.build_model(cfg, n, dtype=dtype, device="cpu")
        model = model.to(dtype)
        convert.load_into(model, convert.variables_to_state_dict(variables))
        state = pengine.create_state(model, pengine.build_optimizer(
            NameSpace({"type": "sgd", "lr": te.LR}), 1))
        loss_fn = pengine.make_loss_fn(loss, 1.0, weights, fused="auto")
        step = pengine.make_train_step(loss_fn)
        tail = pengine.make_tail_step(loss_fn, model, len(ds) % te.BATCH,
                                      step)
        pipe = ppipeline.pipeline_from_dataset(
            ds, te.BATCH, is_training=True, seed=5, num_workers=2,
            reader=ppipeline.SyntheticReader(crop=te.SIZE, seed=1))
        state = pengine.train_epoch(state, pipe, 0, step,
                                    defaultdict(AverageMeter), tail_step=tail)
        pipe.close()
    port = {k: v.detach().numpy().astype(np.float64)
            for k, v in state.model.state_dict().items()}
    jax_sd = {k: np.asarray(v, np.float64)
              for k, v in convert.variables_to_state_dict(ref).items()}
    return port, jax_sd, variables


def _gap(got, want):
    """(largest |got - want|, its key, largest ratio to the test's bound,
    its key) over the keys of ``want``."""
    diff = max(((float(np.abs(got[k] - w).max()), k) for k, w in
                want.items()))
    ratio = max(((float((np.abs(got[k] - w) / (TOL + TOL * np.abs(w)))
                         .max()), k) for k, w in want.items()))
    return diff[0], diff[1], ratio[0], ratio[1]


def _child(loss, root, out):
    _float64()
    import jax

    with open(out, "rb") as f:
        initial = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                         pickle.load(f))
    port, jax_sd, _ = _epochs(loss, root, "float64", initial)
    np.savez(out, **{f"port/{k}": v for k, v in port.items()},
             **{f"jax/{k}": v for k, v in jax_sd.items()})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loss", default="entropic",
                    choices=["entropic", "softmax", "garbage"])
    ap.add_argument("--roots", nargs="+", default=["imagenet"])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(args.loss, args.roots[0], args.child)
        return 0
    for root in args.roots:
        port32, jax32, initial = _epochs(args.loss, root, "float32")
        with tempfile.TemporaryDirectory() as tmp:
            out = pathlib.Path(tmp) / "float64.npz"
            with open(out, "wb") as f:
                pickle.dump(initial, f)
            subprocess.run([sys.executable, "-m", "tests.torch_epoch_float64",
                            "--loss", args.loss, "--roots", root,
                            "--child", str(out)], check=True)
            with np.load(out) as f:
                port64 = {k[5:]: f[k] for k in f.files
                          if k.startswith("port/")}
                jax64 = {k[4:]: f[k] for k in f.files if k.startswith("jax/")}
        line = {"loss": args.loss, "root": root}
        for name, got, want in (("float32", port32, jax32),
                                ("float64", port64, jax64),
                                ("jax32_vs_64", jax32, jax64),
                                ("port32_vs_64", port32, port64)):
            diff, dkey, ratio, rkey = _gap(got, want)
            line[name] = {"max_abs": diff, "at": dkey,
                          "max_ratio_to_bound": ratio, "ratio_at": rkey}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
