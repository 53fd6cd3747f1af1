"""The port's ``dataset/`` against the JAX package's: the first 50
samples of every split of the 14 datasets are equal, sample for sample
(their synthetic generators draw from the same md5-seeded
``RandomState`` in the same order), as are the dictionaries and the
fixed embedding; and ``common.split``, ``cluster_files_reader`` and
``convert`` round-trip.  Nothing is downloaded: ``DATA_HOME`` points at
an empty directory of the test, so every reader takes its synthetic
fallback."""

import itertools
import pickle

import numpy as np
import pytest

import paddle_tpu.dataset as jax_ds
import paddle_tpu_torch.dataset as torch_ds
from paddle_tpu_torch.reader import creator

N_SAMPLES = 50

#: (module, split readers): every reader creator of every dataset
SPLITS = [
    ("mnist", ("train", "test")),
    ("cifar", ("train10", "test10", "train100", "test100")),
    ("uci_housing", ("train", "test")),
    ("imdb", ("train", "test")),
    ("imikolov", ("train", "test")),
    ("movielens", ("train", "test")),
    ("conll05", ("train", "test")),
    ("wmt14", ("train", "test")),
    ("wmt16", ("train", "test", "validation")),
    ("flowers", ("train", "test", "valid")),
    ("sentiment", ("train", "test")),
    ("mq2007", ("train", "test")),
    ("voc2012", ("train", "test", "val")),
]


@pytest.fixture(autouse=True)
def _empty_data_home(tmp_path, monkeypatch):
    for pkg in (jax_ds, torch_ds):
        monkeypatch.setattr(pkg.common, "DATA_HOME", str(tmp_path / "home"))
    monkeypatch.delenv("PADDLE_TPU_DATASET_ONLINE", raising=False)


def assert_same(got, want, where=""):
    """Equal values and structure (lists and tuples alike, arrays by
    value and dtype)."""
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _first(reader_creator):
    return list(itertools.islice(reader_creator(), N_SAMPLES))


@pytest.mark.parametrize("name,splits", SPLITS, ids=[s[0] for s in SPLITS])
def test_first_samples_equal(name, splits):
    for split in splits:
        want = _first(getattr(getattr(jax_ds, name), split)())
        got = _first(getattr(getattr(torch_ds, name), split)())
        assert len(got) == len(want) > 0, (name, split)
        assert_same(got, want, f"{name}.{split}")


def test_dictionaries_and_embedding_equal():
    assert_same(torch_ds.conll05.get_dict(), jax_ds.conll05.get_dict())
    assert_same(torch_ds.conll05.get_embedding(),
                jax_ds.conll05.get_embedding())
    assert torch_ds.conll05.get_embedding().shape == (
        torch_ds.conll05.word_dict_len, 32)
    assert_same(torch_ds.imdb.word_dict(), jax_ds.imdb.word_dict())
    assert_same(torch_ds.imikolov.build_dict(), jax_ds.imikolov.build_dict())
    assert_same(torch_ds.sentiment.get_word_dict(),
                jax_ds.sentiment.get_word_dict())
    assert_same(torch_ds.wmt14.get_dict(), jax_ds.wmt14.get_dict())
    assert_same(torch_ds.wmt16.get_dict("en", 100),
                jax_ds.wmt16.get_dict("en", 100))
    for fn in ("max_user_id", "max_movie_id", "max_job_id",
               "movie_categories"):
        assert_same(getattr(torch_ds.movielens, fn)(),
                    getattr(jax_ds.movielens, fn)())


def test_download_falls_back_without_the_flag():
    """Without ``PADDLE_TPU_DATASET_ONLINE`` a file missing from the
    cache raises (the readers then use their generators); a cached file
    with the right md5 is returned."""
    with pytest.raises(RuntimeError, match="PADDLE_TPU_DATASET_ONLINE"):
        torch_ds.common.download("http://example.invalid/x.bin", "mod",
                                 "0" * 32)
    path = torch_ds.common.DATA_HOME + "/mod/y.bin"
    torch_ds.common.must_mkdirs(torch_ds.common.DATA_HOME + "/mod")
    with open(path, "wb") as f:
        f.write(b"cached")
    md5 = torch_ds.common.md5file(path)
    assert torch_ds.common.download("http://example.invalid/y.bin", "mod",
                                    md5) == path


def test_synthetic_rng_matches():
    for split in ("train", "test", "emb"):
        a = torch_ds.common.synthetic_rng("conll05", split).rand(5)
        b = jax_ds.common.synthetic_rng("conll05", split).rand(5)
        np.testing.assert_array_equal(a, b)


def _reader():
    for i in range(23):
        yield (i, [i] * (i % 4), np.float32(i) / 3)


def test_split_and_cluster_files_reader_round_trip(tmp_path):
    """``split`` writes pickled chunks as the JAX package's does, and two
    trainers' ``cluster_files_reader`` together read every sample back."""
    for pkg, sub in ((torch_ds, "torch"), (jax_ds, "jax")):
        (tmp_path / sub).mkdir()
        pkg.common.split(lambda: _reader(), 5,
                         suffix=str(tmp_path / sub / "%05d.pickle"))
    names = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for n in names:
        with open(tmp_path / "torch" / n, "rb") as f, \
                open(tmp_path / "jax" / n, "rb") as g:
            assert_same(pickle.load(f), pickle.load(g), n)
    pattern = str(tmp_path / "torch" / "*.pickle")
    back = [s for tid in range(2) for s in
            torch_ds.common.cluster_files_reader(pattern, 2, tid)()]
    assert sorted(s[0] for s in back) == list(range(23))
    assert_same(sorted(back, key=lambda s: s[0]), list(_reader()))


def test_convert_round_trips_through_recordio(tmp_path):
    """``convert`` writes recordio files through the port's writer; the
    port's ``reader.creator.recordio`` gives back every sample, in
    order."""
    torch_ds.common.convert(str(tmp_path), lambda: _reader(), 10, "part")
    files = sorted(tmp_path.glob("part-*"))
    assert [f.name for f in files] == ["part-00000", "part-00001",
                                      "part-00002"]
    back = list(creator.recordio([str(f) for f in files])())
    assert_same(back, list(_reader()))
