"""paddle_tpu_torch's ``paddle.text`` against paddle_tpu's, on the CPU.

- ``viterbi_decode`` and ``ViterbiDecoder`` with and without BOS/EOS tags,
  ragged lengths (one row of length 1, one of the full length), scores and
  paths equal: bitwise (the same sums of the same fp32 values in the same
  order; the maxima are exact), and paths cut to the longest length.
  The potentials are drawn from a seed without ties among a step's
  candidates; a case with tied candidates holds the lowest-index rule.
- The text datasets on small synthetic files in their published layouts
  (directory and archive forms), every sample equal; the gated ones raise
  without a file, and raise as the reference does with one.
"""
import io as pyio
import tarfile
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.text as JX
import paddle_tpu_torch.text as PX
import torch_nn_cases as C

port_cpu = pytest.fixture(autouse=True)(C.port_cpu)


def test_all_names_are_ported():
    assert sorted(PX.__all__) == sorted(JX.__all__)
    import importlib

    for mod in ("datasets", "viterbi_decode"):
        j = importlib.import_module(f"paddle_tpu.text.{mod}")
        p = importlib.import_module(f"paddle_tpu_torch.text.{mod}")
        assert sorted(p.__all__) == sorted(j.__all__)


def _viterbi_inputs(seed, b, t, n, full=True):
    rng = np.random.RandomState(seed)
    pot = rng.randn(b, t, n).astype(np.float32)
    trans = rng.randn(n, n).astype(np.float32)
    lens = rng.randint(1, t + 1, b)
    lens[0] = 1
    if full:
        lens[-1] = t
    return pot, trans, lens.astype(np.int64)


@pytest.mark.parametrize("bos_eos", [True, False])
@pytest.mark.parametrize("shape", [(4, 7, 5), (6, 12, 11), (3, 5, 3)])
def test_viterbi_decode_matches_reference(bos_eos, shape):
    pot, trans, lens = _viterbi_inputs(sum(shape) + bos_eos, *shape,
                                       full=shape[0] != 3)
    js, jp = JX.viterbi_decode(paddle_tpu.to_tensor(pot),
                               paddle_tpu.to_tensor(trans),
                               paddle_tpu.to_tensor(lens), bos_eos)
    ts, tp = PX.viterbi_decode(torch.from_numpy(pot), torch.from_numpy(trans),
                               torch.from_numpy(lens), bos_eos)
    assert tp.dtype == torch.int64
    assert tp.shape == (shape[0], int(lens.max()))
    np.testing.assert_array_equal(ts.numpy(), C._np(js))
    np.testing.assert_array_equal(tp.numpy(), C._np(jp))
    assert (tp.numpy()[0, 1:] == 0).all()           # past a row's length


def test_viterbi_decoder_layer_and_ties():
    pot, trans, lens = _viterbi_inputs(3, 5, 9, 6)
    pot[:, :, 2] = pot[:, :, 4]          # tags 2 and 4 alike: emissions,
    trans[:, 2] = trans[:, 4]            # transitions into them
    trans[4] = trans[2]                  # and out of them
    for bos_eos in (True, False):
        jl = JX.ViterbiDecoder(paddle_tpu.to_tensor(trans), bos_eos)
        pl = PX.ViterbiDecoder(torch.from_numpy(trans), bos_eos)
        js, jp = jl(paddle_tpu.to_tensor(pot), paddle_tpu.to_tensor(lens))
        ts, tp = pl(torch.from_numpy(pot), torch.from_numpy(lens))
        np.testing.assert_array_equal(ts.numpy(), C._np(js))
        np.testing.assert_array_equal(tp.numpy(), C._np(jp))
        assert (tp.numpy() != 4).all() and (tp.numpy() == 2).any()


def same_samples(pd, jd, what):
    assert len(pd) == len(jd) > 0, what
    for i in range(len(jd)):
        want, got = jd[i], pd[i]
        if not isinstance(want, tuple):
            want, got = (want,), (got,)
        for g, w in zip(got, want):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, what
            np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")


def test_uci_housing(tmp_path):
    rng = np.random.RandomState(0)
    path = str(tmp_path / "housing.data")
    np.savetxt(path, rng.rand(20, 14) * 50)
    for mode in ("train", "test"):
        same_samples(PX.UCIHousing(path, mode), JX.UCIHousing(path, mode),
                     f"UCIHousing {mode}")


WORDS = "the a movie good bad plot acting great awful film was is".split()


def _docs(rng, n):
    return [" ".join(rng.choice(WORDS, rng.randint(3, 12))).capitalize()
            + "." for _ in range(n)]


def test_imdb(tmp_path):
    rng = np.random.RandomState(1)
    root = tmp_path / "aclImdb"
    tar_path = str(tmp_path / "aclImdb_v1.tar.gz")
    with tarfile.open(tar_path, "w:gz") as tf:
        for mode in ("train", "test"):
            for sub in ("pos", "neg"):
                d = root / mode / sub
                d.mkdir(parents=True)
                for i, doc in enumerate(_docs(rng, 3)):
                    (d / f"{i}_7.txt").write_text(doc)
                    raw = doc.encode()
                    info = tarfile.TarInfo(f"aclImdb/{mode}/{sub}/{i}_7.txt")
                    info.size = len(raw)
                    tf.addfile(info, pyio.BytesIO(raw))
    for path in (str(root), tar_path):
        for mode in ("train", "test"):
            p, j = PX.Imdb(path, mode, cutoff=1), JX.Imdb(path, mode,
                                                          cutoff=1)
            assert p.word_idx == j.word_idx
            same_samples(p, j, f"Imdb {mode}")


def test_imikolov(tmp_path):
    rng = np.random.RandomState(2)
    lines = {w: "\n".join(" ".join(rng.choice(WORDS, rng.randint(2, 9)))
                          for _ in range(12)) for w in ("train", "valid")}
    d = tmp_path / "simple-examples" / "data"
    d.mkdir(parents=True)
    tgz = str(tmp_path / "simple-examples.tgz")
    with tarfile.open(tgz, "w:gz") as tf:
        for w, text in lines.items():
            (d / f"ptb.{w}.txt").write_text(text)
            tf.add(str(d / f"ptb.{w}.txt"),
                   f"./simple-examples/data/ptb.{w}.txt")
    for path in (str(d), tgz):
        for kind, mode in (("NGRAM", "train"), ("SEQ", "test")):
            kw = dict(data_type=kind, window_size=3, mode=mode,
                      min_word_freq=2)
            p, j = PX.Imikolov(path, **kw), JX.Imikolov(path, **kw)
            assert p.word_idx == j.word_idx
            same_samples(p, j, f"Imikolov {kind}")


def test_movielens(tmp_path):
    rng = np.random.RandomState(3)
    d = tmp_path / "ml-1m"
    d.mkdir()
    rows = [f"{rng.randint(1, 50)}::{rng.randint(1, 90)}::"
            f"{rng.randint(1, 6)}::{978300000 + i}" for i in range(60)]
    (d / "ratings.dat").write_text("\n".join(rows))
    zpath = str(tmp_path / "ml-1m.zip")
    with zipfile.ZipFile(zpath, "w") as z:
        z.write(str(d / "ratings.dat"), "ml-1m/ratings.dat")
    for path in (str(d), zpath):
        for mode in ("train", "test"):
            same_samples(PX.Movielens(path, mode, test_ratio=0.25),
                         JX.Movielens(path, mode, test_ratio=0.25),
                         f"Movielens {mode}")


@pytest.mark.parametrize("name", ["Conll05st", "WMT14", "WMT16", "UCIHousing",
                                  "Imdb", "Imikolov", "Movielens"])
def test_datasets_raise_without_files(tmp_path, name):
    with pytest.raises(RuntimeError, match="no local data"):
        getattr(PX, name)()
    with pytest.raises(RuntimeError, match="no local data"):
        getattr(PX, name)(str(tmp_path / "missing"))
    if name in ("Conll05st", "WMT14", "WMT16"):
        path = str(tmp_path / "present")
        open(path, "w").close()
        with pytest.raises(NotImplementedError):
            getattr(PX, name)(path)
        with pytest.raises(NotImplementedError):
            getattr(JX, name)(path)
