"""The port's protocol generator against the JAX package's (CPU).

On ``tests/test_protocol.py``'s fake WordNet metadata and ImageNet tree,
the port's ``protocols`` CLI writes ``p{1,2,3}_{train,val,test}.csv`` and
the ``.tex`` class tables byte for byte as the JAX CLI does, for the
default seed and another; the hierarchy queries and class sets agree;
``util``'s table and archive helpers equal the JAX ones.  The port's CLI
drive (``openset_imagenet_tpu_torch.tools.drive_cli``: protocols ->
train -> evaluate -> predict -> calibrated predict -> serve -> plot ->
learning bar, each in a process of its own) runs at the ``tiny`` variant;
it is marked ``slow`` because its eight processes take over a minute on
the CPU.
"""

import filecmp

import numpy as np
import pytest

from openset_imagenet_tpu import util as jutil
from openset_imagenet_tpu.protocol import OpenSetProtocol as JaxProtocol
from openset_imagenet_tpu.script.protocols import main as jax_protocols
from openset_imagenet_tpu.wordnet import WordNetHierarchy as JaxHierarchy
from openset_imagenet_tpu_torch import util
from openset_imagenet_tpu_torch.protocol import OpenSetProtocol
from openset_imagenet_tpu_torch.script.protocols import main as protocols
from openset_imagenet_tpu_torch.wordnet import (WordNetHierarchy,
                                                common_superclass_wnid)
from tests.test_protocol import fake_tree  # noqa: F401 (module fixture)


@pytest.mark.parametrize("seed", [42, 7])
def test_protocols_cli_writes_the_jax_files(fake_tree, tmp_path, seed,
                                            capsys):
    root, meta, _, _ = fake_tree
    outputs = {}
    for name, cli in (("port", protocols), ("jax", jax_protocols)):
        out = tmp_path / name
        cli(["--protocols", "1", "2", "3", "--imagenet-directory", str(root),
             "--metadata-directory", str(meta), "--output-directory",
             str(out), "--seed", str(seed), "--tex-files",
             *(str(out / f"p{p}.tex") for p in (1, 2, 3))])
        outputs[name] = capsys.readouterr().out.replace(str(out), "OUT")
    assert outputs["port"] == outputs["jax"]
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 12    # 3 protocols x (3 CSVs + the .tex)
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "port", tmp_path / "jax", names, shallow=False)
    assert match == names and not mismatch and not errors


def test_hierarchy_and_class_sets_equal_jax(fake_tree):
    root, meta, supers, _ = fake_tree
    ours, ref = WordNetHierarchy(meta), JaxHierarchy(meta)
    for wnid in supers:
        assert ours.imagenet_descendants(wnid) == \
            ref.imagenet_descendants(wnid)
    assert common_superclass_wnid("mixed_13")
    for num in (1, 2, 3):
        p = OpenSetProtocol(root, meta, protocol_num=num)
        q = JaxProtocol(root, meta, protocol_num=num)
        p.update_classes()
        q.update_classes()
        assert p.kn_classes and p.unk_classes
        assert p.label_map == q.label_map
        assert (p.kn_classes, p.neg_classes, p.unk_classes) == \
            (q.kn_classes, q.neg_classes, q.unk_classes)


def test_util_helpers_equal_jax(tmp_path):
    for name, labels in (("train", [0, 1, -1, -1]), ("validation", [0, -1]),
                         ("test", [0, 1, -1, -2])):
        (tmp_path / f"{name}.csv").write_text("".join(
            f"a/{i}.jpg,{label}\n" for i, label in enumerate(labels)))
    assert str(util.dataset_info(tmp_path)) == \
        str(jutil.dataset_info(tmp_path))
    rng = np.random.default_rng(0)
    arr = {"gt": rng.integers(-2, 4, 50),
           "scores": rng.dirichlet(np.ones(5), 50),
           "features": rng.normal(size=(50, 6))}
    for kw in ({"metric": "score", "drop_bg": True, "unk_label": -2},
               {"metric": "norm", "bins": 7},
               {"metric": "norm", "log_space": True}):
        for got, want in zip(util.get_histogram(arr, **kw),
                             jutil.get_histogram(arr, **kw)):
            np.testing.assert_array_equal(got, want)
    path = tmp_path / "entropic_test_arr_curr.npz"
    np.savez(path, **arr)
    got = util.read_array_list([str(path)])["entropic_test_arr_"]
    np.testing.assert_array_equal(got["gt"], arr["gt"])
    assert util.get_best_arrays({"a": "x/e_curr_arr.npz"}) == \
        jutil.get_best_arrays({"a": "x/e_curr_arr.npz"})
    assert callable(util.plot_oscr) and callable(util.plot_single_oscr)
    with pytest.raises(AttributeError):
        util.enable_compilation_cache


@pytest.mark.slow
def test_drive_cli_on_the_cpu():
    from openset_imagenet_tpu_torch.tools import drive_cli

    acc = drive_cli.main(["--loss", "entropic", "--variant", "tiny",
                          "--epochs", "4", "--device", "cpu"])
    assert acc >= 0.75
