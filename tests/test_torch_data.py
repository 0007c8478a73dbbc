"""The port's input pipeline against the JAX package's: the same files give
the same uint8 batches, filenames and order for (seed, epoch), augmentation
included, and the same masks and normalised images on the device side.
"""

import numpy as np
import pytest
import torch

from dfc_sa_unet_tpu.data import loader as jloader
from dfc_sa_unet_tpu.data.synthetic import generate as jax_generate
from dfc_sa_unet_torch.data import loader as tloader
from dfc_sa_unet_torch.data.dataset import ArrayDataset
from dfc_sa_unet_torch.data.normalize import normalize
from dfc_sa_unet_torch.data.synthetic import generate, samples

torch.set_num_threads(2)


def _config(root, augmentation):
    return {"training": {"batch_size": 3, "num_workers": 2},
            "dataset": {"train_dir": root, "val_dir": root, "img_size": [24, 24], "augmentation": augmentation}}


def test_synthetic_files_equal_the_jax_generator_and_the_in_memory_arrays(tmp_path):
    from PIL import Image

    a = jax_generate(str(tmp_path / "jax"), n=3, size=20, seed=5)
    b = generate(str(tmp_path / "port"), n=3, size=20, seed=5)
    for name, img, mask in samples(n=3, size=20, seed=5):
        for root in (a, b):
            np.testing.assert_array_equal(np.asarray(Image.open(f"{root}/original/{name}")), img)
            np.testing.assert_array_equal(np.asarray(Image.open(f"{root}/mask/{name}")), mask)


@pytest.mark.parametrize("augmentation", [True, False], ids=["augmented", "plain"])
def test_loader_yields_the_jax_loaders_batches(tmp_path, augmentation):
    root = generate(str(tmp_path / "d"), n=8, size=32, seed=1)
    cfg = _config(root, augmentation)
    jf, tf = jloader.DataLoaderFactory(cfg, seed=7), tloader.DataLoaderFactory(cfg, seed=7)
    for get in ("get_train_loader", "get_val_loader"):
        jl, tl = getattr(jf, get)(), getattr(tf, get)()
        assert len(jl) == len(tl) == 3
        for epoch in (0, 3):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            seen = 0
            for jb, tb in zip(jl, tl):
                assert jb["filename"] == tb["filename"]
                assert tb["image"].dtype == tb["mask"].dtype == torch.uint8
                np.testing.assert_array_equal(tb["image"].numpy(), jb["image"])
                np.testing.assert_array_equal(tb["mask"].numpy(), jb["mask"])
                seen += 1
            assert seen == 3
    first = [b["filename"] for b in tf.get_train_loader()]
    other = tf.get_train_loader()
    other.set_epoch(1)
    assert first != [b["filename"] for b in other]  # epochs are shuffled differently


def test_device_side_preparation_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, 6, 5, 3), dtype=np.uint8)
    mask = rng.integers(0, 256, (2, 6, 5), dtype=np.uint8)
    mask[0, 0, :2] = (127, 128)
    got = tloader.binarize_mask(torch.from_numpy(mask))
    want = np.asarray(jloader.binarize_mask_on_device(mask))
    assert got.shape == (2, 1, 6, 5)
    np.testing.assert_array_equal(got[:, 0].numpy(), want[..., 0])
    np.testing.assert_allclose(normalize(torch.from_numpy(img)).numpy(), np.asarray(jloader.normalize_on_device(img)),
                               atol=1e-6)


def test_array_dataset_drop_last_and_shard(tmp_path):
    ds = ArrayDataset(samples(n=5, size=16, seed=2))
    loader = tloader.BatchLoader(ds, 2, shuffle=True, num_workers=1, drop_last=True, seed=3)
    batches = list(loader)
    assert len(batches) == len(loader) == 2 and batches[0]["image"].shape == (2, 16, 16, 3)
    order = np.random.default_rng((3, 0)).permutation(5)
    assert [n for b in batches for n in b["filename"]] == [f"sample_{i:03d}.png" for i in order[:4]]
    imgs, masks = tloader.to_device(batches[0], "cpu")
    assert imgs.dtype == torch.uint8 and masks.shape == (2, 16, 16)
    # a shard of 2 processes: the second process's contiguous chunk of each batch of 2, and of the last
    # batch (one row) only padding, marked by ``valid``
    shard = list(tloader.BatchLoader(ds, 2, shuffle=False, shard=(1, 2)))
    assert [b["filename"] for b in shard] == [["sample_001.png"], ["sample_003.png"], []]
    assert [b["filename_global"] for b in shard][-1] == ["sample_004.png"]
    assert "valid" not in shard[0] and shard[2]["valid"].tolist() == [0.0]
    assert shard[2]["image"].shape == (1, 16, 16, 3) and not shard[2]["image"].any()
    with pytest.raises(ValueError, match="out of range"):
        tloader.BatchLoader(ds, 2, shuffle=False, shard=(2, 2))


def test_a_failing_sample_reaches_the_consumer():
    class Broken(ArrayDataset):
        def __getitem__(self, idx, rng=None):
            raise OSError("unreadable sample")

    with pytest.raises(OSError, match="unreadable"):
        list(tloader.BatchLoader(Broken(samples(n=2, size=8)), 2, shuffle=False))
