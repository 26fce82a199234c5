"""The port's data tier against nf_tpu's, bit for bit, on the CPU.

* The five numpy toy samplers and ``synthetic_images`` (MNIST and CIFAR
  shapes) for the same seeds.
* The native library (the port's copy of the sampler source, built by the
  port into its own build directory) against nf_tpu's: every sampler,
  the shuffle and the row gather, and the ABI version.  Skipped only
  where nf_tpu's own native tests skip: no ``g++``.
* ``load_images`` on small IDX files (plain and ``.gz``) and CIFAR-10
  binary batches written to ``tmp_path``, for ``mnist`` / ``mnist16`` and
  ``cifar10`` / ``cifar16``, and the synthetic fallback.
* ``FlowDataLoader`` batch sequences for a toy density and an image set,
  shard 0 and 1 of 2, with and without ``dequantize``, past an epoch
  refill, with both loaders on the same tier (native, then numpy).
"""
import gzip
import struct

import numpy as np
import pytest

from nf_tpu.data import images as jimages
from nf_tpu.data import native as jnative
from nf_tpu.data import toy as jtoy
from nf_tpu.data.loader import FlowDataLoader as JLoader
from nf_tpu_torch.data import images, native, toy
from nf_tpu_torch.data.loader import POOL_SIZE, FlowDataLoader


@pytest.mark.parametrize("name", sorted(toy.TOY_SAMPLERS))
def test_toy_samplers_bit_for_bit(name):
    fn, dims, dtype = toy.TOY_SAMPLERS[name]
    jfn, jdims, jdtype = jtoy.TOY_SAMPLERS[name]
    assert (dims, dtype) == (jdims, jdtype)
    for seed in (0, 7):
        got = fn(1001, np.random.default_rng(seed))
        want = jfn(1001, np.random.default_rng(seed))
        assert got.dtype == np.float32 and got.shape == (1001,) + dims
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["mnist", "cifar10"])
def test_synthetic_images_bit_for_bit(name):
    got = images.synthetic_images(name, 48, seed=11)
    np.testing.assert_array_equal(got, jimages.synthetic_images(name, 48, seed=11))
    assert got.dtype == np.float32 and got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_array_equal(np.round(got * 255.0) / 255.0, got)   # the 8-bit grid
    assert images.IMAGE_DATASETS == jimages.IMAGE_DATASETS


@pytest.fixture(scope="module")
def both_native():
    if not jnative.available():
        pytest.skip("no g++ / native build unavailable")
    assert native.available()
    return native.load(), jnative.load()


def test_native_library_is_the_ports_own(both_native):
    lib, jlib = both_native
    assert lib.nf_tpu_native_abi_version() == jlib.nf_tpu_native_abi_version() == 1
    so = native.library_path()
    assert so.parent.name == "nf_tpu_torch" and so.exists()
    assert so.parent.parent == native.PACKAGE_DIR.parent / "build"
    assert not list(so.parent.glob("*.tmp"))


@pytest.mark.parametrize("name", sorted(native.NATIVE_SAMPLERS))
def test_native_samplers_bit_for_bit(name, both_native):
    for n, seed in ((1000, 3), (4097, 2**63 + 5)):
        got = native.NATIVE_SAMPLERS[name](n, seed)
        np.testing.assert_array_equal(got, jnative.NATIVE_SAMPLERS[name](n, seed))
        assert got.shape == (n,) + toy.TOY_SAMPLERS[name][1]


def test_native_shuffle_and_gather_bit_for_bit(both_native):
    idx = native.shuffled_indices(5000, 17)
    np.testing.assert_array_equal(idx, jnative.shuffled_indices(5000, 17))
    assert sorted(idx.tolist()) == list(range(5000))
    src = np.random.default_rng(0).standard_normal((5000, 3)).astype(np.float32)
    got = native.gather_rows(src, idx[:300])
    np.testing.assert_array_equal(got, jnative.gather_rows(src, idx[:300]))
    np.testing.assert_array_equal(got, src[idx[:300]])


def _write_idx(path, raw, gz):
    data = struct.pack(">IIII", 2051, *raw.shape) + raw.tobytes()
    if gz:
        with gzip.open(str(path) + ".gz", "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_load_images_mnist_idx(tmp_path, gz):
    raw = np.random.default_rng(1).integers(0, 256, (6, 28, 28), dtype=np.uint8)
    (tmp_path / "MNIST" / "raw").mkdir(parents=True)
    _write_idx(tmp_path / "MNIST" / "raw" / "train-images-idx3-ubyte", raw, gz)
    for name in ("mnist", "mnist16"):
        x, real = images.load_images(name, str(tmp_path))
        want, jreal = jimages.load_images(name, str(tmp_path))
        assert real and jreal
        np.testing.assert_array_equal(x, want)
        assert x.dtype == np.float32 and x.shape == (6,) + images.IMAGE_DATASETS[name]
    x, _ = images.load_images("mnist", str(tmp_path))
    np.testing.assert_array_equal(x[:, 2:30, 2:30, 0] * 255.0, raw.astype(np.float32))
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "train-images-idx3-ubyte").write_bytes(struct.pack(">IIII", 2049, 1, 2, 2) + b"\0" * 4)
    with pytest.raises(ValueError, match="magic"):
        images.load_mnist(str(bad))


def test_load_images_cifar_batches(tmp_path):
    base = tmp_path / "cifar-10-batches-bin"
    base.mkdir()
    rng = np.random.default_rng(2)
    for i in range(1, 6):
        rec = rng.integers(0, 256, (3, 3073), dtype=np.uint8)
        rec.tofile(base / f"data_batch_{i}.bin")
    for name in ("cifar10", "cifar16"):
        x, real = images.load_images(name, str(tmp_path))
        want, _ = jimages.load_images(name, str(tmp_path))
        assert real
        np.testing.assert_array_equal(x, want)
        assert x.dtype == np.float32 and x.shape == (15,) + images.IMAGE_DATASETS[name]
    with pytest.raises(KeyError):
        images.load_images("svhn", str(tmp_path))


def test_load_images_synthetic_fallback(tmp_path):
    x, real = images.load_images("cifar16", str(tmp_path), seed=4, synthetic_n=32)
    want, jreal = jimages.load_images("cifar16", str(tmp_path), seed=4, synthetic_n=32)
    assert not real and not jreal
    np.testing.assert_array_equal(x, want)
    assert x.shape == (32, 16, 16, 3) and x.flags.c_contiguous


# (name, batch size): a refill after POOL_SIZE // 2 // 8192 = 4 toy batches and
# 4096 // 1024 = 4 image batches of a shard (8192 synthetic images over 2 shards)
LOADERS = {"moons": 8192, "mnist16": 1024}


@pytest.mark.parametrize("tier", ["native", "numpy"])
@pytest.mark.parametrize("dequantize", [False, True], ids=["plain", "dequantize"])
@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_sequences_bit_for_bit(name, shard, dequantize, tier, tmp_path):
    if tier == "native" and not jnative.available():
        pytest.skip("no g++ / native build unavailable")
    kw = dict(batch_size=LOADERS[name], total_steps=6, seed=5, data_root=str(tmp_path),
              shard_id=shard, num_shards=2, dequantize=dequantize)
    dl, jdl = FlowDataLoader(name, **kw), JLoader(name, **kw)
    if tier == "numpy":
        dl._native = jdl._native = None
    assert dl.tier == tier
    assert (dl.dims, dl.dtype, dl._pool_n) == (jdl.dims, jdl.dtype, jdl._pool_n)
    got, want = list(dl), list(jdl)
    assert len(got) == len(dl) == 6
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and a.shape == (LOADERS[name],) + dl.dims
        np.testing.assert_array_equal(a, b)
    assert dl._epoch == jdl._epoch == 2   # the pool was refilled
    if name == "moons":
        assert dl._pool_n == POOL_SIZE // 2
    else:
        assert not dl.is_real_data
        grid = np.round(got[0] * 255.0) / 255.0
        assert (np.abs(got[0] - grid) > 0).any() == dequantize


def test_loader_shards_draw_disjoint_streams(tmp_path):
    a = FlowDataLoader("moons", batch_size=64, seed=5, shard_id=0, num_shards=2)
    b = FlowDataLoader("moons", batch_size=64, seed=5, shard_id=1, num_shards=2)
    assert not np.array_equal(a.next_batch(), b.next_batch())
    with pytest.raises(KeyError, match="unknown dataset"):
        FlowDataLoader("spirals")
