"""The port's ``BatchLoader(shard=...)`` against the JAX loader's, array for array
(dfc_sa_unet_tpu/data/loader.py:47-70, 140-182): every process's chunk of every batch, with
``valid``, ``replicated``, ``filename`` and ``filename_global``, through both packages'
``DataLoaderFactory`` over the same image files.  Seven 16x16 images in batches of 4: a batch
that divides among 2 processes, one that does not (3 rows), and among 3 processes a batch of 4
in which the third process holds padding only; pad multiples 1 and 2; the train loader
(``partial='replicate'``, shuffled) and the validation loader (``partial='pad'``).  Then the
port's own ``microbatches=k`` layout for ``grad_accum`` under data parallelism, against the unsharded
loader's batches: each process's share of every microbatch, a microbatch that does not divide, and a
batch that k does not divide."""

import numpy as np
import pytest

from dfc_sa_unet_tpu.data.loader import DataLoaderFactory as JaxFactory
from dfc_sa_unet_torch.data.loader import DataLoaderFactory
from dfc_sa_unet_torch.data.synthetic import generate

KEYS = ("image", "mask", "filename", "valid", "replicated", "filename_global")


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    root = generate(str(tmp_path_factory.mktemp("shard") / "d"), n=7, size=16, seed=8)
    return {"training": {"batch_size": 4, "num_workers": 1},
            "dataset": {"train_dir": root, "val_dir": root, "img_size": [16, 16], "augmentation": False,
                        "cache": False}}


def _batches(loader, epoch=1):
    loader.set_epoch(epoch)
    return [{k: np.asarray(b[k]) if k in ("image", "mask", "valid") else b[k] for k in KEYS if k in b}
            for b in loader]


@pytest.mark.parametrize("nproc,multiple", [(2, 1), (3, 1), (2, 2)])
@pytest.mark.parametrize("kind", ["train", "val"])
def test_shards_equal_the_jax_loaders(cfg, kind, nproc, multiple):
    seen = []
    for pid in range(nproc):
        kw = {"shard": (pid, nproc), "shard_pad_multiple": multiple}
        get = "get_train_loader" if kind == "train" else "get_val_loader"
        got = _batches(getattr(DataLoaderFactory(cfg, seed=4), get)(**kw))
        want = _batches(getattr(JaxFactory(cfg, seed=4), get)(**kw))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w), (set(g), set(w))
            for k in w:
                if isinstance(w[k], np.ndarray):
                    assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
                else:
                    assert g[k] == w[k], k
        seen.append(got)
    # what the cases are there for: a batch that divides, one that pads or replicates (of 2
    # processes the second batch, 3 rows; of 3 the first, 4 rows), and a process that holds padding only
    uneven = 1 if nproc == 2 else 0
    for pid, batches in enumerate(seen):
        if multiple == 1:
            assert "valid" not in batches[1 - uneven] and not batches[1 - uneven].get("replicated")
        if kind == "val":
            assert "valid" in batches[uneven]
        else:
            assert batches[uneven].get("replicated")
    if kind == "val" and nproc == 3:
        assert seen[2][0]["filename"] == [] and not seen[2][0]["valid"].any()


def _loader_batches(items, g, shard=None, k=1):
    from dfc_sa_unet_torch.data.dataset import ArrayDataset
    from dfc_sa_unet_torch.data.loader import BatchLoader

    loader = BatchLoader(ArrayDataset(items), g, shuffle=True, num_workers=1, seed=4, shard=shard,
                         partial="replicate", microbatches=k)
    loader.set_epoch(1)
    return list(loader)


@pytest.mark.parametrize("g,k,nproc", [(8, 2, 2), (12, 3, 2), (16, 2, 4)])
def test_microbatch_shards_reassemble_every_global_microbatch(g, k, nproc):
    """``microbatches=k``: process r's rows, cut into k pieces, are its share of each global microbatch,
    so the pieces of every process, in rank order, give back microbatch m of the unsharded batch."""
    from dfc_sa_unet_torch.data.synthetic import samples

    items = list(samples(n=2 * g, size=8, seed=3))
    whole = _loader_batches(items, g)
    ranks = [_loader_batches(items, g, (r, nproc), k) for r in range(nproc)]
    mb = g // k
    for b, want in enumerate(whole):
        for r in range(nproc):
            got = ranks[r][b]
            assert not got.get("replicated") and "valid" not in got
            assert got["filename_global"] == want["filename"] and got["image"].shape[0] == g // nproc
        for m in range(k):
            names = [n for r in range(nproc) for n in np.array_split(np.array(ranks[r][b]["filename"]), k)[m]]
            images = np.concatenate([np.array_split(ranks[r][b]["image"].numpy(), k)[m] for r in range(nproc)])
            assert names == want["filename"][m * mb:(m + 1) * mb]
            assert np.array_equal(images, want["image"][m * mb:(m + 1) * mb].numpy())


def test_microbatch_that_does_not_divide_loads_the_batch_on_every_process():
    """g 6, k 2, 2 processes: a microbatch of 3 rows does not divide, so each process loads the whole
    batch, marked ``replicated`` (the trainer then runs it with every collective off)."""
    from dfc_sa_unet_torch.data.synthetic import samples

    items = list(samples(n=6, size=8, seed=3))
    whole = _loader_batches(items, 6)[0]
    for r in range(2):
        got = _loader_batches(items, 6, (r, 2), 2)[0]
        assert got["replicated"] and got["filename"] == whole["filename"] == got["filename_global"]
        assert np.array_equal(got["image"].numpy(), whole["image"].numpy())


def test_batch_that_the_microbatch_count_does_not_divide_keeps_the_contiguous_layout():
    """g 8, k 3: the trainer runs the batch as one step, so each process takes its contiguous chunk, as
    without ``microbatches``."""
    from dfc_sa_unet_torch.data.synthetic import samples

    items = list(samples(n=8, size=8, seed=3))
    for r in range(2):
        got = _loader_batches(items, 8, (r, 2), 3)[0]
        plain = _loader_batches(items, 8, (r, 2))[0]
        assert got["filename"] == plain["filename"] and not got.get("replicated")
        assert np.array_equal(got["image"].numpy(), plain["image"].numpy())
