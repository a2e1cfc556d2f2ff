"""The port's data layer (tmar_torch.data: syndeeplesion, spineweb,
spineweb_selfsup, shard_cache, native, nifti; the trainer's ``build_dataset``
and the ``test`` entry point's) against the JAX package's, on the CPU.

Every dataset gives the JAX package's samples exactly (``assert_array_equal``
on shapes, dtypes and values), on a 64² HDF5 tree laid out as SynDeepLesion
and small HU npy trees laid out as SpineWeb, built under ``tmp_path``.  The
shard caches of both packages hold the same bytes and each package reads the
other's.  The host library's five functions equal the JAX module's with the
compiled library and on the numpy path (the same functions in both modules).
NIfTI files are written byte for byte alike.  ``python -m tmar_torch.cli
test`` on both trees agrees with ``tmar.cli.test`` within the serving
tolerance of PERF.md §2: PSNR 1e-3 dB, SSIM 1e-5.
"""

import gzip
import json
import os
import pathlib
import shutil

import h5py
import numpy as np
import pytest
import torch

import tmar.cli as jcli
import tmar.data as jdata
import tmar.train.config as jconfig
import tmar.train.trainer as jtrainer
from tmar.data import native as jnative
from tmar.data import nifti as jnifti
from tmar_torch import NGswin, cli
from tmar_torch import data as tdata
from tmar_torch.data import native, nifti
from tmar_torch.train import config
from tmar_torch.train import trainer as ttrainer
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse: one PyTorch thread)

REPO = pathlib.Path(__file__).parents[1]
DATASET_CLASSES = ("SynDeepLesionTrainDataset", "SynDeepLesionValDataset",
                   "SynDeepLesionTestDataset", "SpineWebDataset",
                   "SpineWebSelfSupervisedDataset", "ShardCachedDataset")


# ---- trees ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def syn_root(tmp_path_factory):
    """SynDeepLesion's layout at 64²: 3 patients x 2 studies of 79 masks in
    train_640geo, 2 test images of 10 masks listed in test_640geo_dir.txt."""
    root = tmp_path_factory.mktemp("syndeeplesion")
    rng = np.random.default_rng(0)
    for split, n_img, n_masks in (("train_640geo", 6, 79), ("test_640geo", 2, 10)):
        for i in range(n_img):
            d = root / split / f"{i // 2:03d}" / f"{i % 2:02d}"
            os.makedirs(d)
            gt = rng.random((64, 64)).astype(np.float32)
            with h5py.File(d / "gt.h5", "w") as f:
                f["image"] = gt
            for k in range(n_masks):
                with h5py.File(d / f"{k}.h5", "w") as f:
                    f["ma_CT"] = np.clip(gt + 0.05 * (k % 7) - 0.1, -0.2, 1.2).astype(np.float32)
                    f["LI_CT"] = (gt * (1 - 0.01 * k)).astype(np.float32)
    with open(root / "test_640geo_dir.txt", "w") as f:
        f.write("000/00/gt.h5\n000/01/gt.h5\n")
    return str(root)


def _write_spineweb(root, n, size=48, metal=False, seed=1):
    rng = np.random.default_rng(seed)
    art, cln = root / "artifact", root / "clean"
    os.makedirs(art)
    os.makedirs(cln)
    for i in range(n):
        clean = rng.uniform(-1200, 2300, (size, size)).astype(np.float32)
        artifact = clean + rng.normal(0, 150, clean.shape).astype(np.float32)
        if metal:
            artifact[10 + i : 14 + i, 20:23] = 3600.0
        np.save(art / f"case{i:03d}.npy", artifact)
        np.save(cln / f"case{i:03d}.npy", clean)
    np.save(art / "only_artifact.npy", np.zeros((size, size), np.float32))  # no partner
    return str(art), str(cln)


@pytest.fixture(scope="module")
def spine_root(tmp_path_factory):
    return _write_spineweb(tmp_path_factory.mktemp("spineweb"), 5)


def _equal(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _same_samples(a, b, indices):
    assert len(a) == len(b)
    for i in indices:
        _equal(a[i], b[i])


# ---- the datasets ---------------------------------------------------------------
def test_data_package_exports_the_jax_package_s_names():
    ported = set(jdata.__all__) - {"BenchmarkFinetuneDataset"}
    assert ported <= set(tdata.__all__)
    for name in DATASET_CLASSES:
        assert getattr(tdata, name).__name__ == name


@pytest.mark.parametrize("patch,length", [(32, 20), (64, 9)], ids=["crop", "full"])
def test_syndeeplesion_train_samples_equal_the_jax_package_s(syn_root, patch, length):
    """Mask ids, crop coordinates before the partial read, and flips: the same
    three RandomState streams in the same order (index order matters)."""
    got = tdata.SynDeepLesionTrainDataset(syn_root, patch_size=patch, length=length, seed=5)
    ref = jdata.SynDeepLesionTrainDataset(syn_root, patch_size=patch, length=length, seed=5)
    assert got.files == ref.files and len(got.files) == 6
    _same_samples(got, ref, [0, 3, 3, 11 % length, 7, 1])
    assert got[2]["ct"].shape == (patch, patch)


def test_syndeeplesion_val_and_test_samples_equal_the_jax_package_s(syn_root):
    val, jval = tdata.SynDeepLesionValDataset(syn_root), jdata.SynDeepLesionValDataset(syn_root)
    assert val.files == jval.files and len(val) == 1  # the last 10 % of six images
    _same_samples(val, jval, [0, 0, 2])
    test, jtest = tdata.SynDeepLesionTestDataset(syn_root), jdata.SynDeepLesionTestDataset(syn_root)
    assert len(test) == len(jtest) == 20  # 2 images x 10 masks
    _same_samples(test, jtest, [0, 1, 5, 19])
    assert test[5]["ct"].shape == (64, 64)


def test_syndeeplesion_skips_and_advances_past_a_corrupt_file(syn_root, tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(syn_root, root)
    bad = sorted(root.glob("train_640geo/*/*/gt.h5"))[0]
    bad.write_bytes(b"not an hdf5 file")
    got = tdata.SynDeepLesionTrainDataset(str(root), patch_size=32, length=8)
    ref = jdata.SynDeepLesionTrainDataset(str(root), patch_size=32, length=8)
    _same_samples(got, ref, [0, 6, 1])
    val, jval = tdata.SynDeepLesionValDataset(str(root), fraction=1.0), \
        jdata.SynDeepLesionValDataset(str(root), fraction=1.0)
    _same_samples(val, jval, [0, 2])
    with pytest.raises(ValueError, match="no gt.h5 files"):
        tdata.SynDeepLesionTrainDataset(str(tmp_path / "empty"))


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_spineweb_samples_equal_the_jax_package_s(spine_root, train):
    kw = dict(patch_size=32, train=train, seed=9, length=12)
    got, ref = tdata.SpineWebDataset(*spine_root, **kw), jdata.SpineWebDataset(*spine_root, **kw)
    assert got.artifact_files == ref.artifact_files and len(got.artifact_files) == 5
    assert len(got) == (12 if train else 5)
    _same_samples(got, ref, [0, 4, 7 % len(got), 2])
    s = got[1]
    assert s["ct"].shape == ((32, 32) if train else (48, 48))
    np.testing.assert_array_equal(s["li"], s["ct"])
    narrow = dict(train=False, hu_range=(-500.0, 1500.0))
    _same_samples(tdata.SpineWebDataset(*spine_root, **narrow),
                  jdata.SpineWebDataset(*spine_root, **narrow), [3])


def test_spineweb_skips_a_corrupt_file_and_refuses_unpaired_trees(spine_root, tmp_path):
    art, cln = _write_spineweb(tmp_path, 4)
    pathlib.Path(art, "case001.npy").write_bytes(b"garbage")
    kw = dict(patch_size=32, train=True, seed=3, length=6)
    _same_samples(tdata.SpineWebDataset(art, cln, **kw), jdata.SpineWebDataset(art, cln, **kw),
                  [1, 0, 5])
    os.makedirs(tmp_path / "none")
    for pkg in (tdata, jdata):
        with pytest.raises(ValueError, match="no matching"):
            pkg.SpineWebDataset(spine_root[0], str(tmp_path / "none"))


@pytest.mark.parametrize("lib", [True, False], ids=["library", "numpy"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_spineweb_selfsup_samples_equal_the_jax_package_s(tmp_path, monkeypatch, lib, train):
    art, _ = _write_spineweb(tmp_path, 3, metal=True)
    if not lib:
        monkeypatch.setattr(native, "load_library", lambda build=True: None)
        monkeypatch.setattr(jnative, "load_library", lambda build=True: None)
    kw = dict(patch_size=32, train=train, seed=4)
    got = tdata.SpineWebSelfSupervisedDataset(art, **kw)
    ref = jdata.SpineWebSelfSupervisedDataset(art, **kw)
    assert got.files == ref.files and len(got) == 4
    _same_samples(got, ref, [0, 1, 2, 1])
    assert not np.array_equal(got[5]["gt"], got[5]["ct"])  # the metal was inpainted


# ---- the shard cache ---------------------------------------------------------------
def _cache_bytes(d):
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(d).iterdir())}


def test_shard_caches_are_the_same_bytes_and_each_package_reads_the_other_s(tmp_path):
    src = jdata.SyntheticMARDataset(size=40, length=7, base_seed=2)
    mine = tdata.build_shard_cache(src, str(tmp_path / "port"), shard_size=3)
    theirs = jdata.build_shard_cache(src, str(tmp_path / "jax"), shard_size=3)
    got, ref = _cache_bytes(mine), _cache_bytes(theirs)
    assert list(got) == list(ref) and len(got) == 1 + 3 * 3  # index.json + 3 keys x 3 shards
    assert got == ref
    assert json.loads(got["index.json"]) == {"version": 1, "keys": ["ct", "gt", "li"],
                                             "shard_sizes": [3, 3, 1], "shape": [40, 40],
                                             "dtype": "float32"}
    kw = dict(patch_size=24, augment=True, seed=8, length=11)
    _same_samples(tdata.ShardCachedDataset(theirs, **kw), jdata.ShardCachedDataset(mine, **kw),
                  [0, 10, 3, 6, 6])
    _same_samples(tdata.ShardCachedDataset(theirs), jdata.ShardCachedDataset(mine), [0, 6])
    with open(os.path.join(mine, "index.json"), "w") as f:
        json.dump({"version": 2}, f)
    with pytest.raises(ValueError, match="unsupported cache version"):
        tdata.ShardCachedDataset(mine)


def test_cache_syndeeplesion_equals_the_jax_package_s(syn_root, tmp_path):
    mine = tdata.cache_syndeeplesion(syn_root, str(tmp_path / "port"), masks_per_image=2,
                                     shard_size=5, seed=3)
    theirs = jdata.cache_syndeeplesion(syn_root, str(tmp_path / "jax"), masks_per_image=2,
                                       shard_size=5, seed=3)
    assert _cache_bytes(mine) == _cache_bytes(theirs)
    assert json.load(open(os.path.join(mine, "index.json")))["shard_sizes"] == [5, 5, 2]


# ---- the host library ---------------------------------------------------------------
def test_host_library_source_is_byte_identical_to_the_jax_package_s():
    assert (REPO / "tmar_torch" / "native" / "tmar_host.cc").read_bytes() == \
        (REPO / "native" / "tmar_host.cc").read_bytes()
    assert native.SOURCE == str(REPO / "tmar_torch" / "native" / "tmar_host.cc")
    assert pathlib.Path(native.library_path()).parent == REPO / "tmar_torch" / "kernels" / "_build"


def _native_calls(rng):
    """(name, args) of each of the five functions, on inputs that reach every
    branch: out-of-range values, a fully masked row and column, flips."""
    img = rng.uniform(-0.4, 1.4, (40, 52)).astype(np.float32)
    hu = rng.uniform(-2000, 4000, (40, 52)).astype(np.float32)
    mask = (rng.random((40, 52)) < 0.15).astype(np.uint8)
    mask[7, :] = 1
    mask[:, 30] = 1
    batch = rng.standard_normal((4, 3, 40, 52)).astype(np.float32)
    return [
        ("normalize01_pm1", (img,)),
        ("hu_window", (hu, -1000.0, 2000.0)),
        ("assemble_batch", (batch, 16, [0, 24, 5, 11], [36, 0, 9, 20], [1, 0, 1, 0], [0, 1, 1, 0])),
        ("metal_mask_dilate", (img, 0.6, 3)),
        ("li_interpolate", (img, mask)),
    ]


@pytest.mark.parametrize("lib", [True, False], ids=["library", "numpy"])
@pytest.mark.parametrize("fn", ["normalize01_pm1", "hu_window", "assemble_batch",
                                "metal_mask_dilate", "li_interpolate"])
def test_native_functions_equal_the_jax_module_s(monkeypatch, lib, fn):
    if lib:
        assert native.available(), native.build_error
        assert jnative.available()
    else:
        monkeypatch.setattr(native, "load_library", lambda build=True: None)
        monkeypatch.setattr(jnative, "load_library", lambda build=True: None)
    args = dict(_native_calls(np.random.default_rng(3)))[fn]
    got, ref = getattr(native, fn)(*args), getattr(jnative, fn)(*args)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_native_library_agrees_with_its_numpy_versions():
    """The compiled functions against the numpy versions, within the
    tolerances of tests/test_native.py where the arithmetic differs."""
    assert native.available(), native.build_error
    calls = dict(_native_calls(np.random.default_rng(4)))
    img, mask = calls["li_interpolate"]
    np.testing.assert_allclose(native.normalize01_pm1(img), native.normalize01_pm1_np(img), rtol=1e-6)
    hu = calls["hu_window"]
    np.testing.assert_allclose(native.hu_window(*hu), native.hu_window_np(*hu), atol=1e-5)
    b, p, r, c, h, v = calls["assemble_batch"]
    np.testing.assert_array_equal(native.assemble_batch(b, p, r, c, h, v),
                                  native.assemble_batch_np(b, p, r, c, h, v))
    np.testing.assert_array_equal(native.metal_mask_dilate(img, 0.6, 3),
                                  native.metal_mask_dilate_np(img, 0.6, 3))
    np.testing.assert_allclose(native.li_interpolate(img, mask),
                               native.li_interpolate_np(img, mask), atol=1e-6)


def test_native_reports_a_missing_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "library_path", lambda: str(tmp_path / "lib.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native.available()
    assert native.build_error
    img = np.random.default_rng(0).uniform(-1, 2, (8, 8)).astype(np.float32)
    np.testing.assert_array_equal(native.normalize01_pm1(img), jnative.normalize01_pm1(img))


# ---- NIfTI -------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8, np.float64])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_nifti_round_trips_byte_for_byte_with_the_jax_package(tmp_path, dtype, suffix):
    rng = np.random.default_rng(5)
    vol = (rng.uniform(0, 200, (6, 5, 4)) - (0 if dtype == np.uint8 else 100)).astype(dtype)
    affine = np.array([[0.8, 0, 0, -10], [0, 0.8, 0, 5], [0, 0, 2.5, 1], [0, 0, 0, 1]])
    mine, theirs = str(tmp_path / f"port{suffix}"), str(tmp_path / f"jax{suffix}")
    nifti.write_nifti(mine, vol, affine)
    jnifti.write_nifti(theirs, vol, affine)
    raw = (lambda p: gzip.open(p).read()) if suffix.endswith(".gz") else \
        (lambda p: pathlib.Path(p).read_bytes())
    assert raw(mine) == raw(theirs)
    for path in (mine, theirs):
        got, ref = nifti.read_nifti(path), jnifti.read_nifti(path)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[0], vol)
        np.testing.assert_allclose(got[1], affine, rtol=1e-6)


def test_nifti_scaling_and_refusals_equal_the_jax_package_s(tmp_path):
    path = tmp_path / "scaled.nii"
    nifti.write_nifti(str(path), np.arange(24, dtype=np.int16).reshape(2, 3, 4))
    raw = bytearray(path.read_bytes())
    raw[112:120] = np.array([0.5, -3.0], "<f4").tobytes()  # scl_slope, scl_inter
    path.write_bytes(bytes(raw))
    got, ref = nifti.read_nifti(str(path)), jnifti.read_nifti(str(path))
    assert got[0].dtype == ref[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[0], np.arange(24).reshape(2, 3, 4) * 0.5 - 3.0)
    (tmp_path / "short.nii").write_bytes(b"\x00" * 40)
    for pkg in (nifti, jnifti):
        with pytest.raises(ValueError, match="truncated"):
            pkg.read_nifti(str(tmp_path / "short.nii"))


# ---- the trainer's build_dataset and build_val_dataset -----------------------------
def _configs(**over):
    return config.load_config(None, over), jconfig.load_config(None, over)


def test_build_dataset_and_val_dataset_give_the_jax_trainer_s_samples(syn_root, spine_root,
                                                                      tmp_path):
    common = {"data.patch_size": 32, "data.samples_per_epoch": 10, "data.seed": 4}
    cases = {
        "synthetic": {},
        "synthetic_cache": {"data.cache_slices": 3},
        "syndeeplesion": {"data.root": syn_root},
        "spineweb": {"data.spineweb_artifact": spine_root[0],
                     "data.spineweb_clean": spine_root[1]},
    }
    for name, over in cases.items():
        mine, ref = _configs(**common, **over, **{"data.dataset": name})
        if name == "synthetic_cache":  # one directory per package
            mine.data.cache_dir = str(tmp_path / "port_cache")
            ref.data.cache_dir = str(tmp_path / "jax_cache")
        got, want = ttrainer.build_dataset(mine), jtrainer.build_dataset(ref)
        assert type(got).__name__ == type(want).__name__ and len(got) == len(want) == 10, name
        _same_samples(got, want, [0, 9, 4])
        got, want = ttrainer.build_val_dataset(mine), jtrainer.build_val_dataset(ref)
        assert type(got).__name__ == type(want).__name__, name
        _same_samples(got, want, [0, len(want) - 1])
    assert _cache_bytes(tmp_path / "port_cache") == _cache_bytes(tmp_path / "jax_cache")


def test_synthetic_cache_default_directory_is_named_apart_from_the_jax_package_s(tmp_path,
                                                                                 monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    mine, ref = _configs(**{"data.dataset": "synthetic_cache", "data.cache_slices": 2,
                            "data.patch_size": 32, "data.samples_per_epoch": 4})
    ttrainer.build_dataset(mine)
    jtrainer.build_dataset(ref)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "tmar_synth_cache_2_999", "tmar_torch_synth_cache_2_999"]
    assert _cache_bytes(tmp_path / "tmar_torch_synth_cache_2_999") == \
        _cache_bytes(tmp_path / "tmar_synth_cache_2_999")


def test_unknown_dataset_raises_value_error():
    mine, ref = _configs(**{"data.dataset": "nope"})
    for fn in (ttrainer.build_dataset, ttrainer.build_val_dataset):
        with pytest.raises(ValueError, match="unknown dataset 'nope'"):
            fn(mine)
    with pytest.raises(ValueError, match="unknown dataset"):
        jtrainer.build_dataset(ref)


# ---- the test entry point ----------------------------------------------------------
TINY_SETS = ["model.embed_dim=32", "model.depths=[2,2,2]", "model.num_heads=[2,2,2]",
             "model.dec_dim=32", "model.dec_depths=2", "model.dec_num_heads=2", "bf16=false"]


@pytest.fixture(scope="module")
def tiny_pth(tmp_path_factory):
    torch.manual_seed(0)
    model = NGswin(ngrams=(2, 2, 2, 2), embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 2),
                   dec_dim=32, dec_depths=2, dec_num_heads=2, device="cpu")
    with torch.no_grad():  # the initial tables are near zero: give every path signal
        for p in model.parameters():
            p.add_(0.02 * torch.randn_like(p))
    path = tmp_path_factory.mktemp("cli") / "tiny.pth"
    torch.save(model.state_dict(), path)
    return str(path)


@pytest.mark.parametrize("dataset,tiled", [("syndeeplesion", False), ("syndeeplesion", True),
                                           ("spineweb", False)])
def test_cli_test_on_real_layouts_matches_jax_cli(syn_root, spine_root, tiny_pth, tmp_path,
                                                  monkeypatch, dataset, tiled):
    monkeypatch.setattr(jcli, "_honor_env_platforms", lambda: None)
    data = ([f"data.root={syn_root}"] if dataset == "syndeeplesion" else
            [f"data.spineweb_artifact={spine_root[0]}", f"data.spineweb_clean={spine_root[1]}"])
    common = ["--config", config.config_path("test_config.yaml"), "--checkpoint", tiny_pth,
              "--max-samples", "3", "--set", *TINY_SETS, f"data.dataset={dataset}", *data,
              *(["--tiled"] if tiled else [])]
    assert jcli.test(["--out", str(tmp_path / "jax"), *common]) == 0
    assert cli.main(["test", "--device", "cpu", "--out", str(tmp_path / "port"), *common]) == 0
    ref = json.load(open(tmp_path / "jax" / "metrics.json"))
    got = json.load(open(tmp_path / "port" / "metrics.json"))
    assert got["summary"]["n"] == ref["summary"]["n"] == 3
    assert got["summary"]["mode"] == ref["summary"]["mode"]
    for g, r in zip(got["per_sample"] + [got["summary"]], ref["per_sample"] + [ref["summary"]]):
        assert abs(g["psnr"] - r["psnr"]) <= 1e-3
        assert abs(g["ssim"] - r["ssim"]) <= 1e-5
