"""The port's CLI workflow end to end, on a synthetic ImageNet tree.

The counterpart of the JAX package's ``tools/drive_cli.py`` stages 0, 1,
2, 4, 4b, 4b2, 5 and 6 and its serve stage, each through the port's own
entry point in a process of its own:

  0. ``script.protocols``  -- synthetic WordNet metadata + JPEG tree ->
                              ``p1_{train,val,test}.csv``
  1. ``script.train``      -- one run on the generated CSVs (64 px)
  2. ``script.evaluate``   -- the val and test archives
  4. ``script.predict``    -- the raw JPEGs of one known class -> a CSV
                              with one row an image, one class for all
  4b. ``script.predict --threshold-at-fpr`` against stage 2's val arrays
  4b2. ``script.predict --optimize int8``, self-calibrated on the same
                              JPEGs: at most one class apart from stage 4
  serve. ``script.serve``  -- the ``.pth`` behind the HTTP daemon; a JSON
                              batch of the same JPEGs reproduces stage
                              4's CSV; SIGTERM ends it with exit code 0
  5. ``script.plot_all``   -- the OSCR/confidence PDF + LaTeX table
  6. a learning bar: known-class test accuracy >= ``--min-acc``

Known (dog) leaves are saturated colours, negative and unknown leaves
grey or dark, so the task is learnable.  The JAX drive's
exported-artifact stages (4c, 4d; its daemon serves the artifact) wait
for ROADMAP Queue 1 item 7, and its multi-process launch for item 8.  The drive writes JPEGs with PIL and its config is YAML, so it
needs PIL and PyYAML::

    python -m openset_imagenet_tpu_torch.tools.drive_cli \\
        [--loss garbage] [--variant resnet50] [--epochs N] [--device cuda]

``--device cpu`` runs every stage on the host.  The tree is made in a
temporary directory and removed unless a stage fails or ``--keep``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

# Protocol-1 superclasses (openset_imagenet_tpu_torch/protocol.py).
DOG = "n02084071"
NEGS = ("n02118333", "n02115335", "n02114100", "n02120997", "n02131653",
        "n02441326", "n02370806", "n02469914")
UNKS = ("n07555863", "n03791235", "n03183080")

KN_COLORS = [(220, 40, 40), (40, 220, 40), (40, 40, 220), (220, 220, 40)]
LABELS = {"entropic": "EOS", "softmax": "S", "garbage": "BG"}
PACKAGE_ROOT = Path(__file__).resolve().parents[2]


def build_metadata(meta: Path) -> dict:
    """Minimal robustness-layout metadata: every superclass gets leaves."""
    meta.mkdir(parents=True)
    edges, words, leaves = [], {}, {}
    wid = 9000000

    def leaf(parent, n):
        nonlocal wid
        out = []
        for _ in range(n):
            wid += 1
            w = f"n{wid:08d}"
            edges.append((parent, w))
            words[w] = f"leaf_{w}"
            out.append(w)
        return out

    for sc in (DOG,) + NEGS + UNKS:
        words[sc] = f"super_{sc}"
    leaves[DOG] = leaf(DOG, len(KN_COLORS))
    for sc in NEGS + UNKS:
        leaves[sc] = leaf(sc, 1)

    with open(meta / "wordnet.is_a.txt", "w") as f:
        f.writelines(f"{p} {c}\n" for p, c in edges)
    with open(meta / "words.txt", "w") as f:
        f.writelines(f"{w}\t{name}\n" for w, name in words.items())
    all_leaves = [w for group in leaves.values() for w in group]
    with open(meta / "imagenet_class_index.json", "w") as f:
        json.dump({str(i): [w, words[w]] for i, w in enumerate(all_leaves)},
                  f)
    return leaves


def leaf_color(leaves, wnid):
    if wnid in leaves[DOG]:
        return KN_COLORS[leaves[DOG].index(wnid)]
    if any(wnid in leaves[sc] for sc in NEGS):
        # A fixed grey per wnid (hash() is salted per process).
        g = 100 + 20 * (int(wnid[1:]) % 5)
        return (g, g, g)
    return (25, 25, 25)


def build_imagenet(root: Path, leaves, train_n=10, val_n=5, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n in (("train", train_n), ("val", val_n)):
        for group in leaves.values():
            for wnid in group:
                d = root / split / wnid
                d.mkdir(parents=True)
                for k in range(n):
                    arr = np.clip(rng.normal(0, 18, (64, 64, 3))
                                  + leaf_color(leaves, wnid), 0, 255)
                    Image.fromarray(arr.astype(np.uint8)).save(
                        d / f"{wnid}_{k}.JPEG", quality=92)


def run(label, args, cwd):
    """``python -m <args>`` in ``cwd``, with this checkout's package on the
    path; raises SystemExit with its output on failure."""
    print(f"--- {label}: {' '.join(map(str, args))}", flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PACKAGE_ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    p = subprocess.run([sys.executable, "-m"] + [str(a) for a in args],
                       capture_output=True, text=True, cwd=cwd, env=env)
    if p.returncode != 0:
        print(p.stdout[-3000:])
        print(p.stderr[-5000:])
        raise SystemExit(f"{label} FAILED rc={p.returncode}")
    return p


def serve_batch(args, blobs, cwd):
    """Start ``python -m <args>`` (the serve CLI) in ``cwd``, wait for its
    ``http://`` line, POST ``blobs`` as one JSON batch, then SIGTERM it;
    returns the results.  Raises SystemExit if it fails or does not exit
    with code 0."""
    import base64
    import re
    import signal
    import urllib.request

    print(f"--- serve: {' '.join(map(str, args))}", flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PACKAGE_ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.Popen([sys.executable, "-m"] + [str(a) for a in args],
                            cwd=cwd, env=env, stderr=subprocess.PIPE,
                            text=True)
    try:
        url, startup = None, []
        for line in proc.stderr:
            startup.append(line)
            m = re.search(r"http://127\.0\.0\.1:(\d+)", line)
            if m:
                url = f"http://127.0.0.1:{m.group(1)}"
                break
        if url is None:
            raise SystemExit("serve: no address logged:\n"
                             + "".join(startup)[-5000:])
        body = json.dumps({"images": [base64.b64encode(b).decode()
                                      for b in blobs]}).encode()
        req = urllib.request.Request(
            url + "/v1/predict", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            results = json.loads(r.read())["results"]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    if proc.returncode != 0:
        raise SystemExit(f"serve: exit code {proc.returncode}")
    return results


def get_args(argv=None):
    ap = argparse.ArgumentParser("drive_cli")
    ap.add_argument("--loss", default="garbage",
                    choices=("entropic", "softmax", "garbage"))
    ap.add_argument("--variant", default="resnet50",
                    help="model.variant of the training config")
    ap.add_argument("--epochs", type=int, default=0,
                    help="0 = per-loss default (12; softmax 20: it trains "
                         "on the known rows only)")
    ap.add_argument("--min-acc", type=float, default=0.75)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="Run the stages on the card (default) or the host")
    ap.add_argument("--keep", action="store_true",
                    help="keep the tree (prints its path)")
    return ap.parse_args(argv)


def main(argv=None) -> float:
    """Run the drive; returns the known-class test accuracy."""
    args = get_args(argv)
    loss = args.loss
    epochs = args.epochs or (20 if loss == "softmax" else 12)
    root = Path(tempfile.mkdtemp(prefix="osi_torch_drive_"))
    ok = False
    try:
        # 0. protocol generation from synthetic metadata
        leaves = build_metadata(root / "meta")
        build_imagenet(root, leaves)
        run("protocols", ["openset_imagenet_tpu_torch.script.protocols",
                          "--protocols", "1",
                          "--imagenet-directory", root,
                          "--metadata-directory", root / "meta",
                          "--output-directory", root / "protocols"], root)
        rows = (root / "protocols" / "p1_train.csv").read_text().split()
        labels = sorted({int(r.rsplit(",", 1)[1]) for r in rows})
        if labels != [-1] + list(range(len(KN_COLORS))):
            raise SystemExit(f"protocols: train labels {labels}")

        # 1. train
        out = root / "experiments" / "Protocol_1"
        out.mkdir(parents=True)
        (root / "train.yaml").write_text(f"""
name: {loss}
checkpoint: null
log_name: {loss}.log
train_mode: train
gpu: null
parallel: true
data:
  imagenet_path: {root}
  train_file: {root}/protocols/p{{}}_train.csv
  val_file: {root}/protocols/p{{}}_val.csv
  test_file: {root}/protocols/p{{}}_test.csv
  reader: pil
  image_size: 64
seed: 42
batch_size: 16
epochs: {epochs}
workers: 2
patience: 0
loss:
  type: {loss}
  w: 1.0
opt:
  type: adam
  lr: 0.001
  decay: 0
  gamma: 1
model:
  variant: {args.variant}
  bn_stats_rows: 8
protocol: 1
output_directory: {out}
""")
        run("train", ["openset_imagenet_tpu_torch.script.train",
                      root / "train.yaml", "1", "-o", out, "--nice", "0",
                      "--device", args.device], root)
        if "Training finished" not in (out / f"{loss}.log").read_text():
            raise SystemExit("train: the log does not end the run")

        # 2. evaluate
        run("evaluate", ["openset_imagenet_tpu_torch.script.evaluate", loss,
                         "1", "--imagenet-directory", root,
                         "--protocol-directory", root / "protocols",
                         "--output-directory", out,
                         "--batch-size", "16", "--workers", "2",
                         "--image-size", "64", "--reader", "pil",
                         "--device", args.device], root)
        for split in ("val", "test"):
            arr = np.load(out / f"{loss}_{split}_arr_curr.npz")
            if not np.allclose(arr["scores"].sum(1), 1.0, rtol=1e-4):
                raise SystemExit(f"evaluate: {split} scores are no softmax")

        # 4. predict: the raw JPEGs of one known class
        n_pred = len(KN_COLORS) + (loss == "garbage")
        dog_dir = root / "val" / leaves[DOG][0]
        pred_base = ["openset_imagenet_tpu_torch.script.predict",
                     out / f"{loss}_curr.pth", str(n_pred), dog_dir,
                     "--image-size", "64", "--batch-size", "8",
                     "--device", args.device]
        if loss == "garbage":
            pred_base.append("--background")
        pred_csv = root / "predictions.csv"
        run("predict", pred_base + ["-o", pred_csv], root)
        lines = pred_csv.read_text().strip().splitlines()
        n_imgs = len(list(dog_dir.glob("*.JPEG")))
        if lines[0] != "path,prediction,score" or len(lines) != 1 + n_imgs:
            raise SystemExit(f"predict: {len(lines)} lines for {n_imgs} "
                             "images")
        rows = [line.rsplit(",", 2) for line in lines[1:]]
        preds = [int(r[1]) for r in rows]
        if not all(0 <= c < len(KN_COLORS) for c in preds) or \
                max(map(preds.count, preds)) < len(preds) - 1:
            raise SystemExit(f"predict: classes {preds}")

        # 4b. the threshold at FPR 0.5 of stage 2's val negatives
        from openset_imagenet_tpu_torch.inference import calibrate_threshold

        val_arr = out / f"{loss}_val_arr_curr.npz"
        calib_csv = root / "predictions_calibrated.csv"
        run("predict(calibrated)", pred_base
            + ["-o", calib_csv, "--threshold-at-fpr", "0.5",
               "--calibrate", val_arr], root)
        threshold = calibrate_threshold(val_arr, 0.5, "softmax",
                                        loss == "garbage")
        crows = [line.rsplit(",", 2) for line in
                 calib_csv.read_text().strip().splitlines()[1:]]
        if [r[0] for r in crows] != [r[0] for r in rows] or any(
                (int(c) == -1) != (float(sc) < threshold)
                for _, c, sc in crows) or all(int(r[1]) == -1
                                              for r in crows):
            raise SystemExit(f"predict(calibrated): threshold {threshold}, "
                             f"rows {crows}")

        # 4b2. int8 serving, self-calibrated on the inputs: quantization
        # noise may move one borderline image (the JAX drive's slack)
        int8_csv = root / "predictions_int8.csv"
        run("predict(int8)", pred_base
            + ["-o", int8_csv, "--optimize", "int8"], root)
        qpreds = [int(line.rsplit(",", 2)[1]) for line in
                  int8_csv.read_text().strip().splitlines()[1:]]
        if len(qpreds) != len(preds) or sum(
                a != b for a, b in zip(qpreds, preds)) > 1:
            raise SystemExit(f"predict(int8): {qpreds} against stage 4's "
                             f"{preds}")

        # serve: the same JPEGs through the daemon reproduce stage 4
        served = serve_batch(
            ["openset_imagenet_tpu_torch.script.serve",
             out / f"{loss}_curr.pth", str(n_pred), "--port", "0",
             "--image-size", "64", "--max-batch", "8",
             "--batch-window-ms", "50", "--device", args.device]
            + (["--background"] if loss == "garbage" else []),
            [Path(r[0]).read_bytes() for r in rows], root)
        if [(str(s["prediction"]), f"{s['score']:.6f}") for s in served] \
                != [(r[1], r[2]) for r in rows]:
            raise SystemExit(f"serve: {served} against stage 4's {rows}")

        # 5. plot
        run("plot", ["openset_imagenet_tpu_torch.script.plot_all",
                     "--protocols", "1", "--loss-functions", loss,
                     "--labels", LABELS[loss],
                     "--output-directory", out.parent,
                     "--imagenet-directory", root,
                     "--protocol-directory", root / "protocols",
                     "--device", args.device], root)
        for name in ("Results_last.pdf", "Results_last.tex"):
            if not (root / name).exists():
                raise SystemExit(f"plot: {name} missing")

        # 6. learning bar
        test = np.load(out / f"{loss}_test_arr_curr.npz")
        kn = test["gt"] >= 0
        acc = float((test["scores"][kn, :len(KN_COLORS)].argmax(1)
                     == test["gt"][kn]).mean())
        print(f"known-class accuracy on test: {acc:.2f}")
        if acc < args.min_acc:
            raise SystemExit(f"model failed to learn: acc={acc}")
        print("DRIVE OK:", loss, "tree at", root)
        ok = True
        return acc
    finally:
        if ok and not args.keep:
            shutil.rmtree(root)
        else:
            print(f"tree kept (failure or --keep): {root}", flush=True)


if __name__ == "__main__":
    main()
