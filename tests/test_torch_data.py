"""The port's data layer against the JAX package's, on the CPU at 160 x 96
images: the cv2 JPEG writer and reader, the synthetic root (`generate` and its
rendered pixels), cv2's float HSV conversions, the photometric distortion
and the whole per-frame pipeline, the dataset's train and test samples,
the samplers and `--cfg-options`.

Images are compared to 1e-3 on the 0-255 scale (float32 arithmetic in a
different order than cv2's); every other field exactly.
"""

import dataclasses
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

from bevformer_tpu.configs import get_config as jax_get_config
from bevformer_tpu.configs.config import apply_overrides as jax_apply_overrides
from bevformer_tpu.data import pipeline as jax_pipeline
from bevformer_tpu.data import sampler as jax_sampler
from bevformer_tpu.data import synth as jax_synth
from bevformer_tpu.data.dataset import NuScenesTemporalDataset as JaxDataset
from bevformer_torch.configs import DataConfig, apply_overrides, get_config
from bevformer_torch.data import image_io, pipeline, sampler, synth
from bevformer_torch.data.dataset import NuScenesTemporalDataset
from tests.torch_port_helpers import port_config

IMG_TOL = 1e-3  # max abs error of an image on the 0-255 scale
W, H = 160, 96
GEN = dict(num_scenes=2, frames_per_scene=4, num_objects=10, img_w=W, img_h=H, seed=3)

JCFG = jax_get_config("bevformer_base")
JCFG = JCFG.replace(data=dataclasses.replace(JCFG.data, raw_size=(H, W), queue_length=3))


def _max_err(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a.astype(np.float64) - np.asarray(b, np.float64)).max())


# ---------------------------------------------------------------- images

@pytest.mark.parametrize("shape", [(1, 1), (96, 160), (7, 33)])
def test_jpeg_round_trip_decodes_as_cv2(tmp_path, shape):
    """write_image / read_image are cv2.imwrite / cv2.imread of a `.jpg`:
    the decode equals cv2's of the same file, and stays within the codec's
    loss of the array written (a smooth image: JPEG keeps low frequencies)."""
    h, w = shape
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([(xx * 255 // max(w - 1, 1)), (yy * 255 // max(h - 1, 1)),
                    np.full_like(xx, 128)], -1).astype(np.uint8)
    path = str(tmp_path / "a.jpg")
    image_io.write_image(path, img)
    assert open(path, "rb").read(3) == b"\xff\xd8\xff"  # a JPEG
    ours = image_io.read_image(path)
    assert ours.dtype == np.uint8 and ours.shape == img.shape
    assert np.array_equal(ours, cv2.imread(path))  # BGR in, BGR out, as cv2
    assert np.abs(ours.astype(int) - img).max() <= 24


def test_image_io_refuses_what_it_cannot_take(tmp_path):
    img = np.random.RandomState(1).randint(0, 256, (16, 24, 3)).astype(np.uint8)
    with pytest.raises(ValueError, match="uint8"):
        image_io.write_image(str(tmp_path / "f.jpg"), img.astype(np.float32))
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        image_io.write_image(str(tmp_path / "g.jpg"), img[..., 0])
    with pytest.raises(FileNotFoundError, match="missing.jpg"):
        image_io.read_image(str(tmp_path / "missing.jpg"))
    (tmp_path / "x.jpg").write_bytes(b"BM" + bytes(60))
    with pytest.raises(FileNotFoundError, match="x.jpg"):
        image_io.read_image(str(tmp_path / "x.jpg"))
    with pytest.raises(RuntimeError, match="could not write"):
        image_io.write_image(str(tmp_path / "no_such_dir" / "a.jpg"), img)


def test_jpeg_goes_to_cv2_or_raises(tmp_path, monkeypatch):
    img = np.random.RandomState(2).randint(0, 256, (16, 24, 3)).astype(np.uint8)
    path = str(tmp_path / "a.jpg")
    image_io.write_image(path, img)
    assert np.array_equal(image_io.read_image(path), cv2.imread(path))
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(RuntimeError, match="a.jpg.*cannot decode.*cv2 does not import"):
        image_io.read_image(path)
    with pytest.raises(RuntimeError, match="b.jpg.*cannot write.*cv2 does not import"):
        image_io.write_image(str(tmp_path / "b.jpg"), img)


# ---------------------------------------------------------------- synthetic root

@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The port's root and the JAX package's at the same seed, with the
    arrays each hands cv2.imwrite captured by file name (the port's are
    written too: its root's JPEGs)."""
    port_root = str(tmp_path_factory.mktemp("port_root"))
    jax_root = str(tmp_path_factory.mktemp("jax_root"))
    ours, captured = {}, {}
    write = cv2.imwrite
    mp = pytest.MonkeyPatch()
    mp.setattr(cv2, "imwrite", lambda path, img: ours.setdefault(
        os.path.basename(path), img.copy()) is not None and write(path, img))
    try:
        synth.generate(port_root, **GEN)
    finally:
        mp.undo()
    mp.setattr(cv2, "imwrite", lambda path, img: captured.setdefault(
        os.path.basename(path), img.copy()) is not None)
    try:
        jax_synth.generate(jax_root, **GEN)
    finally:
        mp.undo()
    return port_root, jax_root, captured, ours


def test_rendered_pixels_equal_jax(roots):
    port_root, _, captured, ours = roots
    names = sorted(os.listdir(os.path.join(port_root, "samples")))
    assert len(names) == len(captured) == len(ours) == 2 * 4 * 6
    assert all(name.endswith(".jpg") for name in names)
    clipped = 0
    for name in names:
        assert np.array_equal(ours[name], captured[name]), name
        img = ours[name]
        clipped += int((img[0] != img[0, :1]).any() or (img[:, 0] != img[:1, 0]).any())
        decoded = image_io.read_image(os.path.join(port_root, "samples", name))
        assert decoded.shape == img.shape and np.array_equal(decoded, cv2.imread(
            os.path.join(port_root, "samples", name)))
    # boxes reach the image's edges, where the fill clips
    assert clipped > 0


def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("split", ["train", "val"])
def test_generated_infos_equal_jax(roots, split):
    port_root, jax_root = roots[:2]
    name = f"nuscenes_infos_temporal_{split}.pkl"
    with open(os.path.join(port_root, name), "rb") as f:
        ours = pickle.load(f)
    with open(os.path.join(jax_root, name), "rb") as f:
        ref = pickle.load(f)
    _equal(ours, ref)
    assert len(ours["infos"]) == 4


# ---------------------------------------------------------------- HSV and the pipeline

def _hsv_cases() -> np.ndarray:
    """BGR float32 pixels on every branch: grey (S = 0), each channel the
    max, ties, every hue sector, negative and past-255 values, and a hue
    just below 0 (wraps to 360)."""
    rng = np.random.RandomState(0)
    px = [rng.uniform(-60, 420, (500, 3)), rng.randint(0, 256, (500, 3))]
    px.append(np.repeat(rng.uniform(-30, 300, (20, 1)), 3, 1))  # grey
    px.append([[10, 10, 200], [200, 10, 10], [10, 200, 10], [200, 200, 10],
               [10, 200, 200], [200, 10, 200], [-5, -5, -5], [-10, -20, -30],
               [0, 0, 0], [100, 100, 100.00001], [50, 50.0001, 50], [100.00001, 99.99999, 100]])
    return np.concatenate([np.asarray(p, np.float32).reshape(-1, 3) for p in px])[None]


def test_bgr_to_hsv_matches_cv2():
    img = _hsv_cases()
    ours = pipeline.bgr_to_hsv(torch.from_numpy(img)).numpy()
    ref = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    assert _max_err(ours, ref) <= IMG_TOL


def test_hsv_to_bgr_matches_cv2():
    rng = np.random.RandomState(1)
    h = np.concatenate([rng.uniform(0, 360, 600), [0, 60, 120, 180, 240, 300, 360, 359.9999,
                                                    1e-6, 59.9999, 60.0001]])
    s = np.concatenate([rng.uniform(0, 1.6, 600), [0, 0.5, 1, 1.5, 0, 1, 0.3, 1, 1, 0.7, 0.7]])
    v = np.concatenate([rng.uniform(-60, 420, 600), [100, -20, 300, 50, 0, 255, 90, 90, 90, 90, 90]])
    hsv = np.stack([h, s, v], -1).astype(np.float32)[None]
    ours = pipeline.hsv_to_bgr(torch.from_numpy(hsv)).numpy()
    ref = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    assert _max_err(ours, ref) <= IMG_TOL


def _images(seed, n=6, h=24, w=40):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, h, w, 3)).astype(np.float32)
    imgs[:, :4] = imgs[:, :4, :1]  # grey rows: S = 0
    imgs[:, 4:6, :, 2] = 255.0  # saturated red
    return imgs


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_photometric_distortion_matches_jax(seed):
    imgs = _images(seed)
    ref_rng, our_rng = np.random.RandomState(seed), np.random.RandomState(seed)
    ref = jax_pipeline.photometric_distortion(list(imgs), ref_rng)
    ours = pipeline.photometric_distortion(torch.from_numpy(imgs), our_rng)
    assert _max_err(ours, np.stack(ref)) <= IMG_TOL
    # the same draws: both generators end in the same state
    assert ref_rng.randint(1 << 30) == our_rng.randint(1 << 30)


@pytest.mark.parametrize("scale,to_rgb,train", [
    (1.0, False, True), (1.0, True, True), (0.5, False, True), (0.8, True, False),
])
def test_preprocess_images_matches_jax(scale, to_rgb, train):
    jdata = dataclasses.replace(JCFG.data, scale=scale, to_rgb=to_rgb, raw_size=(24, 40),
                                size_divisor=16)
    cfg = DataConfig(raw_size=(24, 40), size_divisor=16, scale=scale, to_rgb=to_rgb)
    imgs = _images(7).astype(np.uint8)
    l2i = np.random.RandomState(8).randn(6, 4, 4)
    ref_rng, our_rng = np.random.RandomState(9), np.random.RandomState(9)
    ref, ref_l2i = jax_pipeline.preprocess_images(list(imgs), l2i, jdata, rng=ref_rng, train=train)
    ours, our_l2i = pipeline.preprocess_images(torch.from_numpy(imgs), l2i, cfg, rng=our_rng,
                                               train=train)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    assert _max_err(ours, ref) <= IMG_TOL
    assert our_l2i.dtype == np.float32 and np.array_equal(our_l2i, ref_l2i)


# ---------------------------------------------------------------- dataset and samplers

@pytest.fixture(scope="module")
def datasets(roots):
    port_root = roots[0]
    cfg = port_config(JCFG)

    def pair(split, test_mode):
        ann = os.path.join(port_root, f"nuscenes_infos_temporal_{split}.pkl")
        return (JaxDataset(ann, JCFG, data_root=port_root, seed=11, test_mode=test_mode),
                NuScenesTemporalDataset(ann, cfg, data_root=port_root, seed=11, device="cpu"))

    return pair("train", False), pair("val", True)


def test_train_samples_equal_jax(datasets):
    ref_ds, ds = datasets[0]
    n_none = 0
    for index in list(range(len(ds))) * 2:
        ref, ours = ref_ds.get_train_sample(index), ds.get_train_sample(index)
        assert (ref is None) == (ours is None)
        if ref is None:
            n_none += 1
            continue
        assert sorted(ours) == sorted(ref)
        assert isinstance(ours["images"], torch.Tensor) and ours["images"].device.type == "cpu"
        assert tuple(ours["images"].shape) == ref["images"].shape
        assert _max_err(ours["images"], ref["images"]) <= IMG_TOL
        for key in ref:
            if key != "images":
                _equal(ours[key], ref[key], key)
    assert n_none < len(ds)


def test_test_samples_equal_jax(datasets):
    ref_ds, ds = datasets[1]
    for index in range(len(ds)):
        ref, ours = ref_ds.get_test_sample(index), ds.get_test_sample(index)
        assert sorted(ours) == sorted(ref)
        assert _max_err(ours["images"], ref["images"]) <= IMG_TOL
        for key in ref:
            if key != "images":
                _equal(ours[key], ref[key], key)


def test_annotations_equal_jax(datasets):
    for ref_ds, ds in datasets:
        for info in ds.infos:
            _equal(ds._annotations(info), ref_ds._annotations(info))


def test_datasets_decode_the_same_jpeg_root_identically(datasets, monkeypatch):
    """The port's dataset and the JAX package's read every camera JPEG of
    one root to the same pixels, bit for bit (both through cv2.imread), the
    arrays each hands its pipeline."""
    import bevformer_tpu.data.dataset as jax_dataset_module
    import bevformer_torch.data.dataset as dataset_module

    got = {}
    monkeypatch.setattr(jax_dataset_module, "preprocess_images",
                        lambda imgs, *a, **k: got.__setitem__("jax", np.stack(imgs)))
    monkeypatch.setattr(dataset_module, "preprocess_images",
                        lambda imgs, *a, **k: got.__setitem__("port", imgs.numpy()))
    for ref_ds, ds in datasets:
        for index in range(len(ds)):
            ref_ds._load_frame_images(ref_ds.frame_record(index), train=False)
            ds._load_frame_images(ds.frame_record(index), train=False)
            assert got["port"].dtype == np.uint8 and got["port"].shape == got["jax"].shape
            assert np.array_equal(got["port"].astype(np.float32), got["jax"]), index


@pytest.mark.parametrize("n,replicas,seed", [(7, 1, 0), (10, 3, 4), (16, 4, 1)])
def test_samplers_equal_jax(n, replicas, seed):
    for rank in range(replicas):
        ours = sampler.GroupShuffleSampler(n, replicas, rank, seed)
        ref = jax_sampler.GroupShuffleSampler(n, replicas, rank, seed)
        for epoch in range(3):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert [int(i) for i in ours] == [int(i) for i in ref] and len(ours) == len(ref)
        assert (sampler.ContiguousVideoSampler(n, replicas, rank).indices()
                == jax_sampler.ContiguousVideoSampler(n, replicas, rank).indices())


# ---------------------------------------------------------------- --cfg-options

def test_apply_overrides_matches_jax():
    opts = {"bev_h": "50", "model.bev_w": "50", "use_grid_mask": "False",
            "data.scale": "0.5", "data.to_rgb": "True", "optim.lr": "1e-4",
            "optim.total_epochs": "12"}
    ours = apply_overrides(get_config("bevformer_base"), opts)
    ref = port_config(jax_apply_overrides(jax_get_config("bevformer_base"), opts))
    assert ours == ref


@pytest.mark.parametrize("key,val,err,match", [
    ("no_such_field", "1", KeyError, "unknown key 'no_such_field'"),
    ("data.nope", "1", KeyError, "no field 'nope' in data config"),
    ("model.nope", "1", KeyError, "unknown key 'model.nope'"),
    ("use_grid_mask", "Ture", ValueError, "is not a bool"),
    ("optim.lr", "fast", ValueError, "is not a number"),
])
def test_apply_overrides_raises_jax_errors(key, val, err, match):
    for cfg, fn in ((get_config("bevformer_base"), apply_overrides),
                    (jax_get_config("bevformer_base"), jax_apply_overrides)):
        with pytest.raises(err, match=match):
            fn(cfg, {key: val})
