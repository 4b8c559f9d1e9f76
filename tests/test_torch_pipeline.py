"""The port's dataset index, transforms and input pipeline against the JAX
package's, bit for bit (CPU).

Same CSV, same seed, same epoch: the same paths, labels, label surgery
and class weights; the same Philox draws, crops and synthetic images; the
same batches (images, labels, mask, shuffle order and the tail padded
last with recycled real images), through ``SyntheticReader``, a reader
that crops and flips with each package's own transforms, and
``PILReader`` on small JPEGs.
"""

import numpy as np
import pytest

from openset_imagenet_tpu import dataset as jdataset
from openset_imagenet_tpu import pipeline as jpipeline
from openset_imagenet_tpu import transforms as jT
from openset_imagenet_tpu_torch import dataset as pdataset
from openset_imagenet_tpu_torch import pipeline as ppipeline
from openset_imagenet_tpu_torch import transforms as pT


def _write_csv(path, n=37, seed=0, classes=5):
    rng = np.random.default_rng(seed)
    labels = np.concatenate([np.arange(classes),
                             rng.integers(-1, classes, n - classes)])
    with open(path, "w") as f:
        for i, lab in enumerate(labels):
            f.write(f"n{lab % 7:02d}/img_{i:04d}.JPEG,{lab}\n")
    return path


def _same_index(ours, ref):
    assert len(ours) == len(ref)
    assert list(ours.paths) == list(ref.paths)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    assert ours.labels.dtype == ref.labels.dtype == np.int32
    np.testing.assert_array_equal(ours.unique_classes, ref.unique_classes)
    assert ours.label_count == ref.label_count
    assert ours.has_negatives() == ref.has_negatives()


@pytest.mark.parametrize("surgery", [None, "replace_negative_label",
                                     "remove_negative_label"])
def test_dataset_matches_jax(tmp_path, surgery):
    csv = _write_csv(tmp_path / "p1_train.csv")
    ours = pdataset.ImagenetDataset(csv, tmp_path / "root")
    ref = jdataset.ImagenetDataset(csv, tmp_path / "root")
    if surgery:
        getattr(ours, surgery)()
        getattr(ref, surgery)()
    _same_index(ours, ref)
    np.testing.assert_array_equal(ours.calculate_class_weights(),
                                  ref.calculate_class_weights())
    assert ours.absolute_path(3) == ref.absolute_path(3)


def test_transforms_match_jax():
    for key in [(0, 0, 0, 0), (7, 3, 12345, 2), (2 ** 31, 9, 2 ** 40, 1)]:
        np.testing.assert_array_equal(pT.philox(*key).integers(0, 2 ** 31, 8),
                                      jT.philox(*key).integers(0, 2 ** 31, 8))
    for index in (0, 5, 63):
        np.testing.assert_array_equal(
            pT.synthetic_image(index, (40, 33), seed=3),
            jT.synthetic_image(index, (40, 33), seed=3))
    img = jT.synthetic_image(1, (40, 29))
    for size in (24, 32, 45):
        np.testing.assert_array_equal(pT.center_crop(img, size),
                                      jT.center_crop(img, size))
        np.testing.assert_array_equal(
            pT.random_crop(img, size, pT.sample_rng(1, 2, 3)),
            jT.random_crop(img, size, jT.sample_rng(1, 2, 3)))
        np.testing.assert_array_equal(pT._pad_to(img, size),
                                      jT._pad_to(img, size))
    for extent in range(224, 240):
        assert pT.center_crop_offset(extent, 224) == \
            jT.center_crop_offset(extent, 224)
        assert pT.resized_geometry(extent, 300, 256) == \
            jT.resized_geometry(extent, 300, 256)


class _CropFlipReader:
    """Synthetic pixels through each package's own crop and flip."""

    def __init__(self, T, crop=16):
        self.T, self.crop = T, crop

    def __call__(self, path, rng):
        img = self.T.synthetic_image(int(str(path)[-9:-5]), (20, 23))
        if rng is None:
            return np.ascontiguousarray(self.T.center_crop(img, self.crop))
        img = self.T.random_crop(img, self.crop, rng)
        return np.ascontiguousarray(img[:, ::-1] if rng.random() < 0.5
                                    else img)


def _pipelines(tmp_path, reader, train, **kw):
    csv = _write_csv(tmp_path / "p1_train.csv")
    pipes = []
    for dmod, pmod, T in ((pdataset, ppipeline, pT),
                          (jdataset, jpipeline, jT)):
        ds = dmod.ImagenetDataset(csv, tmp_path)
        r = reader(T) if reader is _CropFlipReader else reader(pmod)
        pipes.append(pmod.pipeline_from_dataset(
            ds, 8, is_training=train, seed=11, num_workers=3, reader=r,
            **kw))
    return pipes


def _same_batches(ours, ref, epoch, start_batch=0):
    got = list(ours.epoch(epoch, start_batch=start_batch))
    want = list(ref.epoch(epoch, start_batch=start_batch))
    assert len(got) == len(want) == len(ref) - start_batch
    for b, (g, w) in enumerate(zip(got, want)):
        for name in ("images", "labels", "mask"):
            a, e = getattr(g, name), getattr(w, name)
            assert a.dtype == e.dtype and a.shape == e.shape, (b, name)
            np.testing.assert_array_equal(a, e, err_msg=f"{b} {name}")
    return got


@pytest.mark.parametrize("reader", ["synthetic", "cropflip"])
@pytest.mark.parametrize("train", [True, False])
def test_batches_match_jax(tmp_path, reader, train):
    make = (_CropFlipReader if reader == "cropflip"
            else lambda mod: mod.SyntheticReader(crop=16, seed=2))
    ours, ref = _pipelines(tmp_path, make, train)
    assert len(ours) == len(ref) == 5
    for epoch in (0, 1):
        got = _same_batches(ours, ref, epoch)
        tail = got[-1]
        # 37 = 4 * 8 + 5: the tail's five valid rows lead, padding last.
        np.testing.assert_array_equal(tail.mask, [1] * 5 + [0] * 3)
        np.testing.assert_array_equal(tail.images[5:], tail.images[:3])
    _same_batches(ours, ref, 2, start_batch=3)
    if train:
        assert not np.array_equal(ours._epoch_order(0), ours._epoch_order(1))
    for p in (ours, ref):
        p.close()


def test_drop_remainder_matches_jax(tmp_path):
    ours, ref = _pipelines(tmp_path, lambda mod: mod.SyntheticReader(crop=8),
                           True, drop_remainder=True)
    assert len(ours) == len(ref) == 4
    _same_batches(ours, ref, 0)


def test_pil_reader_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    paths = []
    for i, (w, h) in enumerate([(40, 30), (30, 47), (36, 36)]):
        path = tmp_path / f"img_{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(path)
        paths.append(str(path))
    for rng_key in (None, (1, 0, 2)):
        ours = ppipeline.PILReader(crop=24, resize=32)
        ref = jpipeline.PILReader(crop=24, resize=32)
        for path in paths:
            r1 = None if rng_key is None else pT.sample_rng(*rng_key)
            r2 = None if rng_key is None else jT.sample_rng(*rng_key)
            np.testing.assert_array_equal(ours(path, r1), ref(path, r2))


def test_worker_errors_and_multiprocess_refusal():
    def bad_reader(path, rng):
        raise OSError(f"cannot read {path}")

    pipe = ppipeline.InputPipeline(["a", "b", "c"], [0, 1, 2], 2, False,
                                   num_workers=2, reader=bad_reader)
    with pytest.raises(OSError, match="cannot read"):
        list(pipe.epoch(0))
    pipe.close()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ppipeline.InputPipeline(["a"], [0], 2, False, process_count=2)
