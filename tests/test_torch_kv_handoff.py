"""The port's KV-page handoff against paddle_tpu's, on the CPU.

Against the reference, on the same inputs:

- ``PageAllocator.adopt_block`` op for op: the same sequences of
  ``ensure``, ``register_blocks``, ``free_slot`` and ``adopt_block`` (fresh,
  duplicate, past a full pool by LRU reclaim, and on a pool with nothing to
  reclaim) leave equal returns, indexes, parents, LRU orders, free heaps and
  int8 scale queues, and both ``check()``s pass; an adopted int8 page leaves
  the reset queue and is established by ``note_scale_copied``;
- ``install_page`` / ``install_page_q`` write the reference's rows and
  scales onto the real pages (the port's pools carry a sink page);
- ``export_kv_pages`` on engines of the same weights serving the same
  prompts, bf16 (the models' fp32 pools) and int8: equal blocks, arrays
  within the fp32 sums' order (int8 rows within one quantum), and, with the
  reference's pool rows copied into the port's pages, equal arrays and
  byte-identical ``encode_kv_payload`` frames;
- the codec: byte-identical frames for bf16 (ml_dtypes on the reference's
  side, ``torch.bfloat16`` on the port's), int8 and fp32 payloads, each
  stack decoding the other's;
- a reference engine's export, framed by the reference and decoded and
  imported by the port's engine: the imported pages hold the exported
  bytes, and the port's greedy continuation equals the reference's stream.

Port against port, the codec cases of ``tests/test_remote.py::
TestKVWireFormat`` and ``tests/test_wire_hardening.py::TestIntegrityCodec``,
and the engine contract: a re-ship dedups every block, a corrupt chain hash
or geometry installs nothing, int8 pages keep their scales through the
engine's fresh-scale flush.
"""
import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.inference import paged_cache as jax_pc
from paddle_tpu.inference.generation import GenerationConfig as JaxGenCfg
from paddle_tpu.inference.generation import \
    PagedContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import remote as jax_remote
from paddle_tpu_torch import GenerationConfig, PagedContinuousBatchingEngine
from paddle_tpu_torch.inference import paged_cache as port_pc
from paddle_tpu_torch.serving import (KVIntegrityError, decode_kv_payload,
                                      encode_kv_payload)

from test_torch_llama import make_pair
from torch_jax_state import jax_reference_state  # noqa: F401

torch.set_num_threads(1)

PS = 4                  # page size of the engine cases
ENGINE_KW = dict(max_batch=2, num_pages=16, page_size=PS, max_pages=8,
                 prefix_cache=True, debug_pages=True)


def _j(x):
    return np.asarray(getattr(x, "value", x))


def _alloc_pair(kv_dtype, num_pages=6, page_size=4):
    kw = dict(num_pages=num_pages, page_size=page_size, max_batch=2,
              max_pages=4, debug=True, prefix_cache=True, kv_dtype=kv_dtype)
    return jax_pc.PageAllocator(**kw), port_pc.PageAllocator(**kw)


def _same_alloc(ja, ta):
    assert ta.page_table.tolist() == ja.page_table.tolist()
    assert ta._index == ja._index
    assert ta._parent_of == ja._parent_of
    assert {k: set(v) for k, v in ta._next.items()} == \
        {k: set(v) for k, v in ja._next.items()}
    assert list(ta._parked.items()) == list(ja._parked.items())
    assert sorted(ta._free) == sorted(ja._free)
    assert ta._fresh_scales == ja._fresh_scales
    assert ta._scaled == ja._scaled
    for name in ("free_pages", "cached_pages", "used_pages"):
        assert getattr(ta, name) == getattr(ja, name), name


def _chain(tokens, ps, salt=b""):
    """(hash, parent, tokens) of each full block of ``tokens``."""
    out, parent = [], port_pc._chain_root(salt)
    for b in range(len(tokens) // ps):
        toks = np.asarray(tokens[b * ps:(b + 1) * ps], np.int32)
        h = port_pc._block_hash(parent, toks)
        out.append((h, parent, toks))
        parent = h
    return out


# -- the allocator -------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_adopt_block_matches_reference_op_for_op(kv_dtype):
    """Adoption parks pages in the LRU under their chain, dedups resident
    hashes (claiming nothing), reclaims the LRU-oldest parked page once the
    free heap is empty, and raises once nothing is reclaimable; both
    allocators agree after every op."""
    ja, ta = _alloc_pair(kv_dtype)
    local = np.arange(1, 9, dtype=np.int32)            # 2 blocks
    for a in (ja, ta):
        a.ensure(0, len(local))
        _, _, hashes = a.lookup_prefix(local)
        a.register_blocks(0, hashes, local, 0, 2)
        a.free_slot(0)                                  # both park
        if kv_dtype == "int8":
            a.take_fresh_scales()
    _same_alloc(ja, ta)
    imported = _chain(np.arange(50, 66, dtype=np.int32), 4)   # 4 blocks
    dup = _chain(local, 4)[1]
    ops = imported[:2] + [dup] + imported[2:] + [imported[0]]
    for h, parent, toks in ops:
        got = [a.adopt_block(h, parent, toks) for a in (ja, ta)]
        assert got[0] == got[1]
        if got[1] is not None and kv_dtype == "int8":
            assert got[1] not in ta._fresh_scales
            for a in (ja, ta):
                a.note_scale_copied(got[1])
        _same_alloc(ja, ta)
        ja.check()
        ta.check()
    # the 6-page pool held 2 local + 4 imported: the 4th import reclaimed
    # the LRU-oldest local page; the repeats were dedups
    assert [a.adopt_block(*dup) for a in (ja, ta)] == [None, None]
    # the chain walk finds imported blocks, partial tail included
    want = np.concatenate([np.arange(50, 66), [1]]).astype(np.int32)
    assert ta.lookup_prefix(want)[:2] == ja.lookup_prefix(want)[:2]
    # every page referenced: nothing to reclaim
    for a in (ja, ta):
        a.ensure(0, 16)
        a.ensure(1, 8)
    _same_alloc(ja, ta)
    h, parent, toks = _chain(np.arange(90, 94, dtype=np.int32), 4)[0]
    for a in (ja, ta):
        with pytest.raises(RuntimeError, match="exhausted"):
            a.adopt_block(h, parent, toks)
    _same_alloc(ja, ta)


def test_adopt_block_contract():
    """A cache-less pool refuses adoption; a partial block is a ValueError."""
    ta = port_pc.PageAllocator(4, 4, 1, 2)
    with pytest.raises(RuntimeError, match="prefix cache"):
        ta.adopt_block(b"x" * 16, b"\0" * 16, [1, 2, 3, 4])
    ta = port_pc.PageAllocator(4, 4, 1, 2, prefix_cache=True)
    with pytest.raises(ValueError, match="FULL block"):
        ta.adopt_block(b"x" * 16, b"\0" * 16, [1, 2, 3])


@pytest.mark.parametrize("dsts", [(4, 1), (4, 1, 4)])
def test_install_page_matches_reference(dsts):
    """Page by page, the reference's rows; a page installed twice holds
    the last install's rows, as the reference's does."""
    rng = np.random.RandomState(1)
    n, ps, h, d = 6, 4, 2, 8
    kp, vp = (rng.randn(n, ps, h, d).astype(np.float32) for _ in range(2))
    rows = rng.randn(len(dsts), ps, h, d).astype(np.float32), \
        rng.randn(len(dsts), ps, h, d).astype(np.float32)
    tk = torch.from_numpy(np.concatenate([kp, np.zeros_like(kp[:1])]))
    tv = torch.from_numpy(np.concatenate([vp, np.zeros_like(vp[:1])]))
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    for i, dst in enumerate(dsts):
        jk, jv = jax_pc.install_page(jk, jv, jnp.int32(dst), rows[0][i],
                                     rows[1][i])
        port_pc.install_page(tk, tv, dst, rows[0][i], rows[1][i])
    np.testing.assert_array_equal(tk[:n].numpy(), _j(jk))
    np.testing.assert_array_equal(tv[:n].numpy(), _j(jv))


def test_install_page_q_matches_reference():
    rng = np.random.RandomState(2)
    n, ps, h, d = 5, 4, 2, 8
    pools = [rng.randint(-127, 128, (n, ps, h, d)).astype(np.int8)
             for _ in range(2)]
    scales = [rng.rand(n, h).astype(np.float32) for _ in range(2)]
    rk, rv = (rng.randint(-127, 128, (ps, h, d)).astype(np.int8)
              for _ in range(2))
    sk, sv = (rng.rand(h).astype(np.float32) for _ in range(2))
    jout = jax_pc.install_page_q(*(jnp.asarray(a) for a in pools + scales),
                                 jnp.int32(3), rk, rv, sk, sv)
    tp = [torch.from_numpy(np.concatenate([a, np.zeros_like(a[:1])]))
          for a in pools + scales]
    port_pc.install_page_q(*tp, 3, rk, rv, sk, sv)
    for t, j in zip(tp, jout):
        np.testing.assert_array_equal(t[:n].numpy(), _j(j))


# -- the engines -----------------------------------------------------------------

def _prompt(n=11, seed=5, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (n,)).astype(
        np.int32)


def _serve_one(eng, ids, n, cfg_cls):
    rid = eng.add_request(ids, cfg_cls(max_new_tokens=n))
    while eng.decode_segment(4):
        pass
    return [int(t) for t in np.asarray(eng.collect_finished()[rid])]


def _engines(kv_dtype, seed=3):
    jm, tm, _ = make_pair(2, 2, seed=seed)
    kw = dict(ENGINE_KW, kv_dtype=kv_dtype)
    return JaxEngine(jm, **kw), PagedContinuousBatchingEngine(tm, **kw)


def _np_layers(payload):
    return [{k: np.asarray(v) for k, v in lay.items()}
            for lay in payload["layers"]]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_export_matches_reference(kv_dtype):
    je, te = _engines(kv_dtype)
    ids = _prompt()
    assert (_serve_one(je, ids, 3, JaxGenCfg)
            == _serve_one(te, ids, 3, GenerationConfig))
    jp, tp = je.export_kv_pages(ids), te.export_kv_pages(ids)
    head = ("version", "kv_dtype", "page_size", "salt", "coverage", "blocks")
    assert {k: tp[k] for k in head} == {k: jp[k] for k in head}
    assert tp["coverage"] == 8 and len(tp["blocks"]) == 2
    for jl, tl in zip(_np_layers(jp), _np_layers(tp)):
        assert sorted(jl) == sorted(tl)
        for key in jl:
            assert tl[key].dtype == jl[key].dtype
            if tl[key].dtype == np.int8:
                assert np.abs(tl[key].astype(np.int32)
                              - jl[key].astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(tl[key], jl[key], rtol=1e-5,
                                           atol=1e-5)
    # with the reference's rows on the port's pages the export is exact,
    # down to the framed bytes
    pids = te.alloc.lookup_prefix(ids)[0]
    assert pids == je.alloc.lookup_prefix(ids)[0]
    for tentry, jentry in zip(te.caches, je.caches[0]):
        for t, j in zip(tentry, jentry):
            t[:-1].copy_(torch.from_numpy(np.array(_j(j))))
    tp = te.export_kv_pages(ids)
    for jl, tl in zip(_np_layers(jp), _np_layers(tp)):
        for key in jl:
            np.testing.assert_array_equal(tl[key], jl[key])
    assert encode_kv_payload(tp) == jax_remote.encode_kv_payload(jp)


def test_export_salted_and_partial_tail():
    """Only full blocks ship, chained from the salt's root."""
    _, te = _engines("bf16")
    ids = _prompt(10)
    salt = b"adapter@1"
    te.alloc.ensure(0, len(ids))
    _, _, hashes = te.alloc.lookup_prefix(ids, salt=salt)
    te.alloc.register_blocks(0, hashes, ids, 0, 2, salt=salt)
    p = te.export_kv_pages(ids, salt=salt)
    assert p["salt"] == salt.hex() and p["coverage"] == 8
    assert p["blocks"][0]["parent"] == port_pc._chain_root(salt).hex()
    assert p["blocks"][1]["parent"] == p["blocks"][0]["hash"]
    assert te.export_kv_pages(ids)["blocks"] == []      # unsalted: no hit


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_reference_export_imported_by_the_port(kv_dtype):
    """The reference engine prefills, exports and frames; the port decodes
    and imports into a fresh engine: its pages hold the exported bytes, a
    re-ship dedups every block, and its greedy continuation of the prompt
    plus the first token is the reference's stream."""
    je, te = _engines(kv_dtype)
    ids = _prompt(13, seed=9)
    want = _serve_one(je, ids, 6, JaxGenCfg)
    jp = je.export_kv_pages(ids)
    got = decode_kv_payload(jax_remote.encode_kv_payload(jp))
    fresh = te.alloc.free_pages
    assert te.import_kv_pages(got) == {"imported": 3, "deduped": 0,
                                       "coverage": 12}
    assert te.import_kv_pages(got) == {"imported": 0, "deduped": 3,
                                       "coverage": 12}
    assert te.alloc.cached_pages == 3 and te.alloc.free_pages == fresh - 3
    pids = te.alloc.lookup_prefix(ids)[0][:3]
    for entry, lay in zip(te.caches, _np_layers(jp)):
        for t, key in zip(entry, ("k", "v", "k_scale", "v_scale")):
            np.testing.assert_array_equal(t[pids].numpy(), lay[key])
    te.alloc.check()
    cont = _serve_one(te, np.concatenate([ids, want[:1]]).astype(np.int32),
                      5, GenerationConfig)
    assert te.alloc.prefix_hits == 1
    assert cont == want[1:]
    if kv_dtype == "int8":
        # the flush that ran before the continuation's writes kept them
        for entry, lay in zip(te.caches, _np_layers(jp)):
            np.testing.assert_array_equal(entry[2][pids].numpy(),
                                          lay["k_scale"])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_import_past_the_reclaimable_pages(kv_dtype):
    """An import of more blocks than the pool can reclaim: later blocks
    reclaim pages this same import adopted, and every indexed page holds
    its own block's rows (the last install wins); the allocator ends as
    the reference's after the same import."""
    jm, tm, _ = make_pair(2, 2, seed=3)
    kw = dict(ENGINE_KW, kv_dtype=kv_dtype)
    src = JaxEngine(jm, **kw)
    ids = _prompt(17, seed=4)
    _serve_one(src, ids, 1, JaxGenCfg)
    jp = src.export_kv_pages(ids)
    assert len(jp["blocks"]) == 4
    je, te = JaxEngine(jm, **kw), PagedContinuousBatchingEngine(tm, **kw)
    for eng in (je, te):
        # live rows hold 14 of the 16 pages: 2 left to reclaim
        eng.alloc.ensure(0, 8 * PS)
        eng.alloc.ensure(1, 6 * PS)
    got = te.import_kv_pages(decode_kv_payload(
        jax_remote.encode_kv_payload(jp)))
    assert got == je.import_kv_pages(jp) == {
        "imported": 4, "deduped": 0, "coverage": 16}
    _same_alloc(je.alloc, te.alloc)
    te.alloc.check()
    resident = [(b, te.alloc._index[bytes.fromhex(blk["hash"])])
                for b, blk in enumerate(jp["blocks"])
                if bytes.fromhex(blk["hash"]) in te.alloc._index]
    assert [b for b, _ in resident] == [2, 3]
    assert len({pid for _, pid in resident}) == 2
    for entry, lay in zip(te.caches, _np_layers(jp)):
        for t, key in zip(entry, ("k", "v", "k_scale", "v_scale")):
            for b, pid in resident:
                np.testing.assert_array_equal(t[pid].numpy(), lay[key][b])


def test_import_validates_before_installing():
    """A wrong dtype, page size, layer count, short rows, geometry or a
    chain hash that does not match its (parent, tokens) raise ValueError and
    claim nothing, even where the bad block is not the first."""
    _, te = _engines("bf16")
    src = PagedContinuousBatchingEngine(te.model, **ENGINE_KW)
    ids = _prompt(12)
    _serve_one(src, ids, 1, GenerationConfig)
    good = src.export_kv_pages(ids)
    free = te.alloc.free_pages

    def broken(**edit):
        p = dict(good, layers=[dict(lay) for lay in good["layers"]],
                 blocks=[dict(b) for b in good["blocks"]])
        for k, v in edit.items():
            v(p) if callable(v) else p.__setitem__(k, v)
        return p

    cases = {
        "kv_dtype": broken(kv_dtype="int8"),
        "page_size": broken(page_size=8),
        "layer count": broken(layers=good["layers"][:1]),
        "short": broken(x=lambda p: p["layers"][1].__setitem__(
            "v", good["layers"][1]["v"][:2])),
        "geometry": broken(x=lambda p: p["layers"][0].__setitem__(
            "k", good["layers"][0]["k"][:, :, :1])),
        "chain hash": broken(x=lambda p: p["blocks"][2].__setitem__(
            "tokens", [0] * PS)),
    }
    for what, p in cases.items():
        with pytest.raises(ValueError, match=what):
            te.import_kv_pages(p)
        assert te.alloc.free_pages == free and te.alloc.cached_pages == 0
    assert te.import_kv_pages(good)["imported"] == 3


# -- the codec ---------------------------------------------------------------------

def _codec_payloads(kv_dtype, nblocks=3, layers=2):
    """The same payload for both stacks: the reference's arrays (ml_dtypes
    bf16) and the port's (torch bf16), from one fp32 draw."""
    rng = np.random.RandomState(4)
    keys = ("k", "v", "k_scale", "v_scale") if kv_dtype == "int8" \
        else ("k", "v")
    ids = np.arange(1, 1 + nblocks * PS, dtype=np.int32)
    blocks = [{"hash": h.hex(), "parent": p.hex(), "tokens": t.tolist()}
              for h, p, t in _chain(ids, PS)]
    jl, tl = [], []
    for _ in range(layers):
        jlay, tlay = {}, {}
        for key in keys:
            shape = (nblocks, 2) if key.endswith("scale") \
                else (nblocks, PS, 2, 8)
            x = rng.randn(*shape).astype(np.float32)
            if key.endswith("scale"):
                jlay[key], tlay[key] = x, torch.from_numpy(x)
            elif kv_dtype == "int8":
                q = (x * 40).astype(np.int8)
                jlay[key], tlay[key] = q, torch.from_numpy(q)
            elif kv_dtype == "bf16":
                jlay[key] = x.astype(ml_dtypes.bfloat16)
                tlay[key] = torch.from_numpy(x).to(torch.bfloat16)
            else:
                jlay[key], tlay[key] = x, torch.from_numpy(x)
        jl.append(jlay)
        tl.append(tlay)
    head = {"version": 1, "kv_dtype": kv_dtype, "page_size": PS,
            "salt": "", "coverage": nblocks * PS, "blocks": blocks}
    return dict(head, layers=jl), dict(head, layers=tl)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "fp32"])
def test_codec_byte_identical_across_stacks(kv_dtype):
    jp, tp = _codec_payloads(kv_dtype)
    raw = jax_remote.encode_kv_payload(jp)
    assert encode_kv_payload(tp) == raw
    # a numpy payload (no bf16 there) frames the same too
    if kv_dtype != "bf16":
        assert encode_kv_payload(jp) == raw
    got = decode_kv_payload(raw)
    back = jax_remote.decode_kv_payload(encode_kv_payload(tp))
    for tlay, jlay, blay in zip(got["layers"], jp["layers"], back["layers"]):
        for key, want in jlay.items():
            t = tlay[key]
            if kv_dtype == "bf16" and not key.endswith("scale"):
                assert t.dtype == torch.bfloat16
                t = t.view(torch.int16)
                want = want.view(np.int16)
            np.testing.assert_array_equal(t.numpy(), want)
            assert blay[key].dtype == jlay[key].dtype
            np.testing.assert_array_equal(blay[key].view(np.uint8),
                                          jlay[key].view(np.uint8))


def test_codec_integrity_names_the_block():
    _, tp = _codec_payloads("bf16")
    raw = encode_kv_payload(tp)
    n = int.from_bytes(raw[:4], "big")
    block_bytes = PS * 2 * 8 * 2
    for b in range(3):
        bad = bytearray(raw)
        bad[4 + n + b * block_bytes + 3] ^= 0x01
        with pytest.raises(KVIntegrityError, match=f"at block {b}"):
            decode_kv_payload(bytes(bad))
    with pytest.raises(KVIntegrityError, match="truncated"):
        decode_kv_payload(raw[:-10])


class TestKVWireFormat:
    """The framing cases of the reference's ``test_remote.py``."""

    @staticmethod
    def _payload(kv_dtype="bf16"):
        rng = np.random.default_rng(0)
        dt = torch.bfloat16 if kv_dtype == "bf16" else torch.int8

        def arr(*shape):
            x = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32))
            return x.to(dt) if dt == torch.bfloat16 else (x * 20).to(dt)

        lay = {"k": arr(2, 8, 4), "v": arr(2, 8, 4)}
        if kv_dtype == "int8":
            lay["k_scale"] = torch.from_numpy(
                rng.standard_normal((2, 8)).astype(np.float32))
            lay["v_scale"] = torch.from_numpy(
                rng.standard_normal((2, 8)).astype(np.float32))
        return {"version": 1, "kv_dtype": kv_dtype, "page_size": 8,
                "salt": "", "coverage": 16,
                "blocks": [{"hash": "aa", "parent": None,
                            "tokens": list(range(8))},
                           {"hash": "bb", "parent": "aa",
                            "tokens": list(range(8, 16))}],
                "layers": [lay]}

    @pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
    def test_round_trip_exact(self, kv_dtype):
        p = self._payload(kv_dtype)
        out = decode_kv_payload(encode_kv_payload(p))
        assert out["kv_dtype"] == kv_dtype
        assert out["blocks"] == p["blocks"]
        assert out["coverage"] == 16
        for key, arr in p["layers"][0].items():
            got = out["layers"][0][key]
            assert got.dtype == arr.dtype and got.shape == arr.shape
            assert torch.equal(got, arr)

    def test_truncated_body_is_value_error(self):
        raw = encode_kv_payload(self._payload())
        with pytest.raises(ValueError, match="truncated"):
            decode_kv_payload(raw[:-10])

    def test_trailing_bytes_are_value_error(self):
        raw = encode_kv_payload(self._payload())
        with pytest.raises(ValueError, match="trailing"):
            decode_kv_payload(raw + b"x")

    def test_short_and_bogus_headers_are_value_errors(self):
        with pytest.raises(ValueError, match="too short"):
            decode_kv_payload(b"\x00\x00")
        with pytest.raises(ValueError, match="out of bounds"):
            decode_kv_payload(b"\xff\xff\xff\xff{}")
        with pytest.raises(ValueError, match="not JSON"):
            decode_kv_payload(b"\x00\x00\x00\x02xx")

    def test_wrong_version_rejected(self):
        p = self._payload()
        p["version"] = 99
        with pytest.raises(ValueError, match="version"):
            decode_kv_payload(encode_kv_payload(p))

    def test_unknown_dtype_and_negative_dims_rejected(self):
        raw = encode_kv_payload(self._payload())
        n = int.from_bytes(raw[:4], "big")
        hdr = json.loads(raw[4:4 + n])
        for edit, match in ((("dtype", "complex64"), "dtype"),
                            (("shape", [2, -8, 4]), "negative")):
            h = json.loads(json.dumps(hdr))
            h["layers"][0]["k"][edit[0]] = edit[1]
            body = json.dumps(h).encode()
            with pytest.raises(ValueError, match=match):
                decode_kv_payload(len(body).to_bytes(4, "big") + body
                                  + raw[4 + n:])


def _ramp_payload(nblocks=2, layers=2, page=8, heads=2):
    ramp = np.arange(nblocks * page * heads,
                     dtype=np.float32).reshape(nblocks, page, heads)
    return {"version": 1, "kv_dtype": "float32", "page_size": page,
            "salt": "", "coverage": nblocks * page,
            "blocks": [{"hash": f"{b:02x}" * 4, "tokens": page}
                       for b in range(nblocks)],
            "layers": [{"k": ramp + li, "v": ramp - li}
                       for li in range(layers)]}


class TestIntegrityCodec:
    """The integrity cases of the reference's ``test_wire_hardening.py``."""

    def test_round_trip(self):
        p = _ramp_payload()
        out = decode_kv_payload(encode_kv_payload(p))
        assert out["blocks"] == p["blocks"]
        for got, want in zip(out["layers"], p["layers"]):
            assert np.array_equal(got["k"].numpy(), want["k"])
            assert np.array_equal(got["v"].numpy(), want["v"])

    def test_flip_names_the_block(self):
        raw = bytearray(encode_kv_payload(_ramp_payload()))
        raw[-1] ^= 0xFF                   # last array byte -> block 1
        with pytest.raises(KVIntegrityError, match="block 1"):
            decode_kv_payload(bytes(raw))

    def test_truncation_is_typed(self):
        raw = encode_kv_payload(_ramp_payload())
        with pytest.raises(KVIntegrityError, match="truncated|trailing"):
            decode_kv_payload(raw[:len(raw) - 8])

    def test_digestless_payload_still_decodes(self):
        """A hand-built frame without digests decodes unverified; its
        truncation stays a plain ValueError (no integrity claim made)."""
        p = _ramp_payload(layers=1)
        arr = np.ascontiguousarray(p["layers"][0]["k"])
        hdr = json.dumps({
            "version": 1, "kv_dtype": "float32", "page_size": 8,
            "salt": "", "coverage": p["coverage"], "blocks": p["blocks"],
            "layers": [{"k": {"dtype": "float32", "shape": list(arr.shape)},
                        "v": {"dtype": "float32",
                              "shape": list(arr.shape)}}]}).encode()
        raw = (len(hdr).to_bytes(4, "big") + hdr + arr.tobytes()
               + arr.tobytes())
        out = decode_kv_payload(raw)
        assert np.array_equal(out["layers"][0]["v"].numpy(), arr)
        with pytest.raises(ValueError) as ei:
            decode_kv_payload(raw[:len(raw) - 8])
        assert not isinstance(ei.value, KVIntegrityError)
