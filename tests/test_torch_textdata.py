"""The port's text and recordio ingest against the JAX package's, on the CPU.

Everything here is host-side integer and byte work (parsing, hashing,
splitting, framing, localizing, padding), so every comparison is exact:
arrays equal element for element, files equal byte for byte.
"""

import os

import numpy as np
import pytest
import torch

from wormhole_tpu.data import feed as jfeed
from wormhole_tpu.data import hashing as jhash
from wormhole_tpu.data import input_split as jsplit
from wormhole_tpu.data import localizer as jloc
from wormhole_tpu.data import minibatch as jmb
from wormhole_tpu.data import native as jnative
from wormhole_tpu.data import parsers as jparse
from wormhole_tpu.data import recordio as jrec
from wormhole_tpu_torch.data import feed as tfeed
from wormhole_tpu_torch.data import hashing as thash
from wormhole_tpu_torch.data import input_split as tsplit
from wormhole_tpu_torch.data import localizer as tloc
from wormhole_tpu_torch.data import minibatch as tmb
from wormhole_tpu_torch.data import native as tnative
from wormhole_tpu_torch.data import parsers as tparse
from wormhole_tpu_torch.data import recordio as trec
from wormhole_tpu_torch.data import stream as tstream
from wormhole_tpu_torch.data.pipeline import DeviceFeed


def libsvm_text(rng, n, vals=True):
    """libsvm rows: labels, some unlabeled rows, binary and valued
    features, an empty row and a blank line."""
    lines = []
    for i in range(n):
        ids = rng.integers(0, 1 << 40, rng.integers(0, 30))
        feats = " ".join(f"{j}:{rng.random():.5g}" if vals and i % 3
                         else f"{j}" for j in ids)
        head = "" if i % 17 == 5 else f"{int(rng.random() < 0.4)} "
        lines.append((head + feats).strip() or "0")
        if i % 50 == 7:
            lines.append("")
    return ("\n".join(lines) + "\n").encode()


def criteo_text(rng, n):
    """criteo rows: label, 13 integer slots, 26 hex categoricals, some of
    each missing, and a short (skipped) line."""
    lines = []
    for i in range(n):
        ints = [("" if rng.random() < 0.2 else str(rng.integers(0, 500)))
                for _ in range(13)]
        cats = [("" if rng.random() < 0.2 else f"{rng.integers(0, 1 << 32):08x}")
                for _ in range(26)]
        lines.append("\t".join([str(int(rng.random() < 0.3))] + ints + cats))
        if i == 3:
            lines.append("1\t2\t3")
    return ("\n".join(lines) + "\n").encode()


def adfea_text(rng, n):
    """adfea rows: lineid, count, label, then feaid:groupid pairs."""
    lines = []
    for i in range(n):
        pairs = " ".join(f"{rng.integers(0, 1 << 50)}:{rng.integers(0, 9)}"
                         for _ in range(rng.integers(1, 20)))
        lines.append(f"{i} 1 {int(rng.random() < 0.5)} {pairs}")
    return ("\n".join(lines) + "\n").encode()


TEXT = {"libsvm": libsvm_text, "criteo": criteo_text, "adfea": adfea_text}


def assert_blocks_equal(a, b):
    """Two RowBlocks (of either package) equal field by field."""
    assert a.size == b.size
    for f in ("offset", "label", "index"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in ("value", "weight"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.array_equal(x, y), f


@pytest.mark.parametrize("fmt", ["libsvm", "criteo", "adfea"])
def test_parsers_match_jax(fmt):
    """Each Python chunk parser, and the native one the port loads, give
    the JAX package's RowBlocks exactly."""
    chunk = TEXT[fmt](np.random.default_rng(len(fmt)), 300)
    want = jparse._TEXT_PARSERS[fmt](chunk)
    assert want.size > 0
    assert_blocks_equal(tparse._TEXT_PARSERS[fmt](chunk), want)
    assert tnative.available() == jnative.available()
    native = tnative.get_parser(fmt)
    if native is not None:
        assert_blocks_equal(native(chunk), want)
    got = list(tparse.iter_blocks([chunk[:len(chunk) // 2]], fmt))
    ref = list(jparse.iter_blocks([chunk[:len(chunk) // 2]], fmt))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert_blocks_equal(a, b)


def test_hashing_matches_jax():
    """The key folds and string hashes are the JAX package's bit for bit."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**63, 10000, dtype=np.uint64) * np.uint64(2)
    for nb in (1 << 10, 1 << 22, 12345):
        assert np.array_equal(thash.fold_keys(keys, nb),
                              jhash.fold_keys(keys, nb))
        assert np.array_equal(thash.fold_keys(keys, nb, hashed=False),
                              jhash.fold_keys(keys, nb, hashed=False))
    assert np.array_equal(thash.key64_to_key32(keys),
                          jhash.key64_to_key32(keys))
    assert np.array_equal(thash.splitmix64_np(keys),
                          jhash.splitmix64_np(keys))
    for s in (b"", b"a", b"68fd1e64", bytes(range(256))):
        assert thash.crc32_hash(s) == jhash.crc32_hash(s)


def test_recordio_files_byte_identical_both_ways(tmp_path):
    """Both writers emit the same bytes for the same rows (payloads holding
    aligned MAGIC words split into continuation records), and each
    package's reader returns the other's payloads, for every part of n."""
    rng = np.random.default_rng(9)
    magic = np.frombuffer(np.uint32(trec.MAGIC).tobytes() * 2, np.uint64)
    rows = []
    for i in range(400):
        idx = rng.integers(0, 2**63, rng.integers(0, 12), dtype=np.uint64)
        if i % 37 == 0:
            idx = np.concatenate([idx, magic, idx[:1]])
        val = (rng.random(len(idx)).astype(np.float32) if i % 2 else None)
        rows.append((float(i % 2), idx, val))
    paths = {}
    for name, mod in (("t", trec), ("j", jrec)):
        paths[name] = str(tmp_path / f"{name}.rec")
        with open(paths[name], "wb") as f:
            w = mod.RecordWriter(f)
            for lab, idx, val in rows:
                w.write_row(lab, idx, val)
    data = open(paths["t"], "rb").read()
    assert data == open(paths["j"], "rb").read()
    want = [p for p in jrec.RecordStream(paths["j"])]
    assert len(want) == len(rows)
    for nparts in (1, 3, 7):
        got_t = [p for k in range(nparts)
                 for p in trec.RecordStream(paths["j"], k, nparts)]
        got_j = [p for k in range(nparts)
                 for p in jrec.RecordStream(paths["t"], k, nparts)]
        assert got_t == want and got_j == want
    for a, b in zip(trec.iter_record_blocks(want, 64),
                    jrec.iter_record_blocks(want, 64)):
        assert_blocks_equal(a, b)


def test_part_ranges_and_text_split_match_jax(tmp_path):
    """``part_ranges`` over several files and the newline-aligned chunks of
    every part equal the JAX package's for several ``nparts``; the parts
    cover every line exactly once."""
    rng = np.random.default_rng(2)
    for i in range(3):
        (tmp_path / f"part-{i}.txt").write_bytes(libsvm_text(rng, 200 + i))
    uri = str(tmp_path / "part-.*")
    tfiles, jfiles = tsplit.resolve_files(uri), jsplit.resolve_files(uri)
    assert [(f.path, f.size) for f in tfiles] == \
        [(f.path, f.size) for f in jfiles]
    whole = b"".join(open(f.path, "rb").read() for f in tfiles)
    for nparts in (1, 2, 5, 13):
        for k in range(nparts):
            got = [(f.path, lo, hi)
                   for f, lo, hi in tsplit.part_ranges(tfiles, k, nparts)]
            want = [(f.path, lo, hi)
                    for f, lo, hi in jsplit.part_ranges(jfiles, k, nparts)]
            assert got == want
        chunks = [list(tsplit.InputSplit(uri, k, nparts, chunk_bytes=997))
                  for k in range(nparts)]
        ref = [list(jsplit.InputSplit(uri, k, nparts, chunk_bytes=997))
               for k in range(nparts)]
        assert chunks == ref
        assert b"".join(c for part in chunks for c in part) == whole


def test_stream_refuses_remote_schemes():
    """Remote schemes are not ported: listing or opening one raises."""
    with pytest.raises(ValueError, match="not ported"):
        tstream.get_filesystem("s3://bucket/key")
    with pytest.raises(ValueError, match="not ported"):
        tsplit.resolve_files("hdfs://nn/data")


@pytest.mark.parametrize("fmt,nparts,mb", [("libsvm", 1, 37),
                                           ("libsvm", 3, 100),
                                           ("criteo", 2, 64),
                                           ("recordio", 2, 50)])
def test_minibatch_iter_matches_jax(tmp_path, fmt, nparts, mb):
    """``MinibatchIter`` re-slices into the same minibatches, in the same
    order, with the same tail, for every part."""
    rng = np.random.default_rng(mb)
    path = str(tmp_path / "data")
    if fmt == "recordio":
        with open(path, "wb") as f:
            w = trec.RecordWriter(f)
            for i in range(333):
                idx = rng.integers(0, 2**40, 7, dtype=np.uint64)
                w.write_row(float(i % 2), idx, None)
    else:
        open(path, "wb").write(TEXT[fmt](rng, 333))
    for k in range(nparts):
        got = list(tmb.MinibatchIter(path, k, nparts, fmt, mb))
        want = list(jmb.MinibatchIter(path, k, nparts, fmt, mb))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert_blocks_equal(a, b)
        assert all(b.size == mb for b in got[:-1])


def localize_cases(rng):
    blk = tparse.parse_libsvm_chunk(libsvm_text(rng, 120))
    yield dict(num_buckets=1 << 12), blk, 8, None
    yield dict(num_buckets=1 << 20, tail_freq=1), blk, 16, 512
    yield dict(num_buckets=1 << 8), blk, 4, None      # truncates rows


def test_localizer_and_pad_to_batch_match_jax():
    """Localize (fold, dedup, tail filter) then pad (positional truncation,
    key padding) equal the JAX package's arrays exactly, and the port's
    batch carries num_real and num_keys."""
    rng = np.random.default_rng(4)
    for kw, blk, max_nnz, kpad in localize_cases(rng):
        lt, lj = tloc.Localizer(**kw).localize(blk), \
            jloc.Localizer(**kw).localize(blk)
        assert np.array_equal(lt.uniq_keys, lj.uniq_keys)
        assert np.array_equal(lt.freq, lj.freq)
        assert_blocks_equal(lt.block, lj.block)
        bt = tfeed.pad_to_batch(lt, 128, max_nnz, kpad)
        bj = jfeed.pad_to_batch(lj, 128, max_nnz, kpad)
        for f in tfeed.TENSOR_FIELDS:
            x, y = getattr(bt, f).numpy(), np.asarray(getattr(bj, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert bt.num_real == bj.num_real == blk.size
        assert bt.num_keys == len(lj.uniq_keys)
    for n in (0, 1, 8, 9, 5000):
        assert tfeed.nnz_bucket(n) == jfeed.nnz_bucket(n)
        assert tfeed.next_bucket(n, 64) == jfeed.next_bucket(n, 64)


def test_device_feed_workers_give_the_serial_batches(tmp_path):
    """A DeviceFeed at 0 and at 2 workers (with the learner's monotone
    max_nnz context) yields the same batches in the same order, equal to
    the JAX DeviceFeed's serial output; an error in a stage surfaces after
    every batch that precedes it."""
    from wormhole_tpu.data.pipeline import DeviceFeed as JFeed
    rng = np.random.default_rng(8)
    path = str(tmp_path / "d.libsvm")
    open(path, "wb").write(libsvm_text(rng, 900))

    def run(feed_cls, workers):
        loc = tloc.Localizer(num_buckets=1 << 16)
        state = {"nnz": 0}

        def ctx(blk):
            state["nnz"] = max(state["nnz"], tfeed.batch_max_nnz(blk))
            return state["nnz"]

        def prep(blk, nnz):
            return tfeed.pad_to_batch(loc.localize(blk), 64, nnz, 0)

        kw = dict(workers=workers, seq_ctx=ctx)
        if feed_cls is JFeed:
            kw["transfer"] = lambda b: b
        return list(feed_cls(tmb.MinibatchIter(path, 0, 1, "libsvm", 64),
                             prep, **kw))

    serial = run(DeviceFeed, 0)
    for other in (run(DeviceFeed, 2), run(JFeed, 0)):
        assert len(other) == len(serial) == 15
        for a, b in zip(other, serial):
            for f in tfeed.TENSOR_FIELDS:
                assert torch.equal(getattr(a, f), getattr(b, f))

    def bad(item, ctx):
        if item == 5:
            raise KeyError("stage 5")
        return item

    for workers in (0, 2):
        got = []
        with pytest.raises(KeyError, match="stage 5"):
            for x in DeviceFeed(range(9), bad, workers=workers):
                got.append(x)
        assert got == [0, 1, 2, 3, 4]


def test_native_parser_is_the_shared_build():
    """The port loads the repo's one native build (native/build, made with
    ``make -C native`` on first use), the library the JAX package loads."""
    assert tnative.available() == jnative.available()
    lib = tnative._find_lib()
    assert (lib is not None) == tnative.available()
    if lib is not None:
        assert os.path.realpath(lib) == os.path.realpath(jnative._find_lib())
