"""Read-ID binning codec.

Capability parity with the reference's IDProcess (SURVEY.md C8,
srcfile:IDProcess.cpp: analysisIDBinType @0x4310a0 / encodeIDS /
decodeIDS @0x430610): ID lines are tokenized into digit / non-digit fields;
fields that are constant or arithmetic sequences across the block collapse
to a tiny descriptor (the bundled test data's sequential IDs compress to
~48 bytes per block in the reference).  Variable fields fall back to a
byte stream coded by the generic adaptive byte model on-device.

The whole header line after '@' (including any comment) is treated as the
ID, so comments round-trip for free.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

_TOKEN_RE = re.compile(rb"\d+|\D+")

MODE_TEXT_CONST = 0   # identical text in every read
MODE_NUM_CONST = 1    # identical numeric token (string-identical)
MODE_NUM_DELTA = 2    # value_i = start + step*i, fixed rendering width
MODE_NUM_VAR = 3      # numeric, stored as per-read values (zigzag deltas)
MODE_TEXT_VAR = 4     # arbitrary text per read
MODE_NUM_DELTA2 = 5   # stride-2 arithmetic (PE-interleaved ids):
                      # v[2k] = s1 + d*k, v[2k+1] = s2 + d*k


def _tokenize(s: bytes) -> List[bytes]:
    return _TOKEN_RE.findall(s)


def _renders_back(values: List[int], tokens: List[bytes]) -> bool:
    """Numeric tokens must re-render to the identical string."""
    return all(str(v).encode() == t for v, t in zip(values, tokens))


@dataclass
class IdBinSchema:
    fields: List[dict]

    def to_json(self) -> bytes:
        return json.dumps(self.fields).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "IdBinSchema":
        return cls(json.loads(raw.decode()))


def analyze_ids(ids: List[bytes]) -> Tuple[Optional[IdBinSchema], bytes]:
    """Returns (schema, var_payload) or (None, b"") when binning fails.

    var_payload is the concatenated variable-field byte stream (newline
    separated per read per var field) to be entropy-coded by the caller.

    Fast path for big blocks: analyze a small sample; if the sample schema
    is fully generative (const/delta fields only), render the whole block
    from it and accept on a single bytes compare — skipping the per-ID
    tokenization that dominates host time on large blocks.
    """
    R = len(ids)
    if R > 2048:
        out = _analyze_ids_vec(ids)
        if out is not NotImplemented:
            return out
        # no native library: probe a sample, verify by rendering
        schema, var = _analyze_ids_full(ids[:512])
        if schema is not None and not var and all(
                f["m"] in (MODE_TEXT_CONST, MODE_NUM_CONST, MODE_NUM_DELTA,
                           MODE_NUM_DELTA2) for f in schema.fields):
            if b"".join(reconstruct_ids(schema, R, b"")) == b"".join(ids):
                return schema, b""
    return _analyze_ids_full(ids)


def _parse_fixed_width(buf: np.ndarray, starts: np.ndarray,
                       W: int) -> np.ndarray:
    """(R,) int64 values of W-digit tokens at byte offsets `starts`."""
    vals = np.zeros(len(starts), np.int64)
    for k in range(W):
        vals = vals * 10 + (buf[starts + k].astype(np.int64) - 48)
    return vals


def _analyze_ids_vec(ids: List[bytes]):
    """Vectorized analyze_ids over the native tokenizer: one C pass builds
    token boundaries, then every column test (const / arithmetic / stride-2
    / leading-zero rendering) is a numpy reduction.  Returns NotImplemented
    when the native library is unavailable (caller uses the Python path);
    otherwise bit-identical (schema, var_payload) to _analyze_ids_full."""
    from fastqueeze_tpu_torch.io import native
    from fastqueeze_tpu_torch.io.fastq import LazyLines
    R = len(ids)
    if isinstance(ids, LazyLines):
        offs = ids.offs
        buf = np.frombuffer(ids.cat, np.uint8)
    else:
        lens = np.fromiter((len(s) for s in ids), np.int64, R)
        offs = np.zeros(R + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        buf = np.frombuffer(b"".join(ids), np.uint8)
    tok = native.id_tokenize(buf, offs, cap=max(64 * R, 1024))
    if tok is None:
        return NotImplemented
    ntok, tstart, tend = tok
    if R == 0 or not (ntok == ntok[0]).all():
        return (None, b"") if R else (IdBinSchema([]), b"")
    nf = int(ntok[0])
    if nf == 0:
        return None, b""
    starts = tstart.reshape(R, nf)
    ends = tend.reshape(R, nf)
    widths = ends - starts
    first = buf[starts]
    isd = (first >= 48) & (first <= 57)
    if (isd != isd[0]).any():
        return None, b""

    fields = []
    var_chunks: List[bytes] = []
    for i in range(nf):
        s_i, w_i = starts[:, i], widths[:, i]
        W0 = int(w_i[0])
        fixed_w = bool((w_i == W0).all())
        is_num = bool(isd[0, i])
        if fixed_w:
            col2d = native.gather(buf, s_i, ends[:, i], R * W0)
            col2d = col2d.reshape(R, W0)
            if (col2d == col2d[0]).all():
                v = col2d[0].tobytes().decode("latin1")
                fields.append({"m": MODE_NUM_CONST if is_num
                               else MODE_TEXT_CONST, "v": v})
                continue
        if not is_num:
            fields.append({"m": MODE_TEXT_VAR})
            var_chunks.append(_join_column(buf, s_i, ends[:, i]))
            continue
        # numeric column: values must re-render to the identical string
        # (no leading zeros unless width 1); tokens beyond int64 range are
        # deferred to the arbitrary-precision Python path
        if w_i.max() > 18:
            return NotImplemented
        renders = bool(((buf[s_i] != 48) | (w_i == 1)).all())
        if renders:
            if fixed_w:
                values = _parse_fixed_width(buf, s_i, W0)
            else:
                values = np.zeros(R, np.int64)
                for W in np.unique(w_i):
                    m = w_i == W
                    values[m] = _parse_fixed_width(buf, s_i[m], int(W))
            step = int(values[1] - values[0]) if R > 1 else 0
            if (np.diff(values) == step).all():
                fields.append({"m": MODE_NUM_DELTA, "s": int(values[0]),
                               "d": step})
                continue
            if R > 3:
                d2 = int(values[2] - values[0])
                ev, od = values[0::2], values[1::2]
                if ((ev == values[0] + d2 * np.arange(len(ev))).all()
                        and (od == values[1] + d2 * np.arange(len(od))).all()):
                    fields.append({"m": MODE_NUM_DELTA2, "s": int(values[0]),
                                   "s2": int(values[1]), "d": d2})
                    continue
            fields.append({"m": MODE_NUM_VAR})
            deltas = np.empty(R, np.int64)
            deltas[0] = values[0]
            np.subtract(values[1:], values[:-1], out=deltas[1:])
            rendered = native.render_dec(deltas)
            if rendered is None:
                rendered = b"\n".join(b"%d" % d for d in deltas) + b"\n"
            var_chunks.append(rendered)
            continue
        fields.append({"m": MODE_TEXT_VAR})
        var_chunks.append(_join_column(buf, s_i, ends[:, i]))

    return IdBinSchema(fields), b"".join(var_chunks)


def _join_column(buf: np.ndarray, starts: np.ndarray,
                 ends: np.ndarray) -> bytes:
    """b"\\n".join of the column's token bytes + trailing newline, built by
    one gather into a buffer with per-token newline slots."""
    from fastqueeze_tpu_torch.io import native
    w = ends - starts
    R = len(starts)
    out_lens = w + 1
    out_ends = np.cumsum(out_lens)
    out = np.full(int(out_ends[-1]), 10, np.uint8)   # prefill newlines
    g = native.gather(buf, starts, ends, int(w.sum()))
    if g is None or not native.scatter(g, out_ends - out_lens, w, out):
        parts = [buf[s:e].tobytes() for s, e in zip(starts, ends)]
        return b"\n".join(parts) + b"\n"
    return out.tobytes()


def _analyze_ids_full(ids: List[bytes]) -> Tuple[Optional[IdBinSchema], bytes]:
    if not ids:
        return IdBinSchema([]), b""
    tok0 = _tokenize(ids[0])
    nf = len(tok0)
    cols: List[List[bytes]] = [[] for _ in range(nf)]
    for s in ids:
        toks = _tokenize(s)
        if len(toks) != nf:
            return None, b""
        for i, t in enumerate(toks):
            cols[i].append(t)
    # token-class consistency
    for i in range(nf):
        is_num0 = tok0[i][:1].isdigit()
        for t in cols[i]:
            if t[:1].isdigit() != is_num0:
                return None, b""

    fields = []
    var_chunks: List[bytes] = []
    R = len(ids)
    for i in range(nf):
        col = cols[i]
        is_num = tok0[i][:1].isdigit()
        first = col[0]
        if all(t == first for t in col):
            fields.append({"m": MODE_NUM_CONST if is_num else MODE_TEXT_CONST,
                           "v": first.decode("latin1")})
            continue
        if not is_num:
            fields.append({"m": MODE_TEXT_VAR})
            var_chunks.append(b"\n".join(col) + b"\n")
            continue
        values = [int(t) for t in col]
        if _renders_back(values, col):
            step = values[1] - values[0] if R > 1 else 0
            if all(values[k] == values[0] + step * k for k in range(R)):
                fields.append({"m": MODE_NUM_DELTA, "s": values[0], "d": step})
                continue
            if R > 3:
                d2 = values[2] - values[0]
                if (all(values[2 * k] == values[0] + d2 * k
                        for k in range((R + 1) // 2))
                        and all(values[2 * k + 1] == values[1] + d2 * k
                                for k in range(R // 2))):
                    fields.append({"m": MODE_NUM_DELTA2, "s": values[0],
                                   "s2": values[1], "d": d2})
                    continue
            fields.append({"m": MODE_NUM_VAR})
            deltas = np.diff(np.asarray([0] + values, dtype=object))
            var_chunks.append(b"\n".join(str(int(d)).encode() for d in deltas)
                              + b"\n")
            continue
        # leading zeros / exotic rendering -> raw text column
        fields.append({"m": MODE_TEXT_VAR})
        var_chunks.append(b"\n".join(col) + b"\n")

    return IdBinSchema(fields), b"".join(var_chunks)


_POW10 = np.array([10 ** k for k in range(19)], np.int64)


def _render_ints(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Decimal-render non-negative int64 values -> (flat u8 bytes, widths).
    Groupwise by digit count: each group renders as a (n, W) digit matrix."""
    R = len(values)
    widths = np.searchsorted(_POW10[1:], values, side="right") + 1
    offs = np.cumsum(widths) - widths
    out = np.empty(int(widths.sum()), np.uint8)
    for W in np.unique(widths):
        m = widths == W
        v = values[m]
        cols = np.empty((len(v), W), np.uint8)
        for k in range(W - 1, -1, -1):
            v, d = np.divmod(v, 10)
            cols[:, k] = d
        flat_idx = (offs[m][:, None] + np.arange(W)[None, :]).reshape(-1)
        out[flat_idx] = (cols + 48).reshape(-1)
    return out, widths


def _var_line_spans(var_payload: bytes):
    buf = np.frombuffer(var_payload, np.uint8)
    nl = np.flatnonzero(buf == 10)
    starts = np.empty_like(nl)
    if len(nl):
        starts[0] = 0
        starts[1:] = nl[:-1] + 1
    return buf, starts, nl


def _parse_signed_lines(buf, starts, ends) -> Optional[np.ndarray]:
    """Vectorized int64 parse of decimal lines (optional leading '-')."""
    if len(starts) == 0:
        return np.zeros(0, np.int64)
    neg = buf[starts] == 45
    s = starts + neg
    w = ends - s
    if len(w) and int(w.max()) > 18:
        return None
    vals = np.zeros(len(s), np.int64)
    for W in np.unique(w):
        m = w == W
        vals[m] = _parse_fixed_width(buf, s[m], int(W))
    return np.where(neg, -vals, vals)


def _reconstruct_ids_vec(schema: IdBinSchema, n_reads: int,
                         var_payload: bytes):
    """Vectorized reconstruct_ids: render every field as (flat bytes,
    widths), then compose all IDs with native byte scatters.  Returns
    NotImplemented when a field needs the Python path."""
    from fastqueeze_tpu_torch.io import native
    if native.get_lib() is None:
        return NotImplemented
    R = n_reads
    vbuf, vstarts, vends = _var_line_spans(var_payload)
    vi = 0
    rendered = []            # (flat u8, widths) per field
    for f in schema.fields:
        m = f["m"]
        if m in (MODE_TEXT_CONST, MODE_NUM_CONST):
            v = np.frombuffer(f["v"].encode("latin1"), np.uint8)
            rendered.append((np.tile(v, R), np.full(R, len(v), np.int64)))
        elif m == MODE_NUM_DELTA:
            values = f["s"] + f["d"] * np.arange(R, dtype=np.int64)
            if len(values) and (values.min() < 0
                                or values.max() >= _POW10[18]):
                return NotImplemented
            rendered.append(_render_ints(values))
        elif m == MODE_NUM_DELTA2:
            values = np.empty(R, np.int64)
            values[0::2] = f["s"] + f["d"] * np.arange((R + 1) // 2)
            values[1::2] = f["s2"] + f["d"] * np.arange(R // 2)
            if len(values) and (values.min() < 0
                                or values.max() >= _POW10[18]):
                return NotImplemented
            rendered.append(_render_ints(values))
        elif m == MODE_NUM_VAR:
            s, e = vstarts[vi * R:(vi + 1) * R], vends[vi * R:(vi + 1) * R]
            vi += 1
            deltas = _parse_signed_lines(vbuf, s, e)
            if deltas is None:
                return NotImplemented
            values = np.cumsum(deltas)
            if len(values) and (values.min() < 0
                                or values.max() >= _POW10[18]):
                return NotImplemented
            rendered.append(_render_ints(values))
        else:  # MODE_TEXT_VAR
            s, e = vstarts[vi * R:(vi + 1) * R], vends[vi * R:(vi + 1) * R]
            vi += 1
            w = (e - s).astype(np.int64)
            flat = native.gather(vbuf, s, e, int(w.sum()))
            rendered.append((flat, w))

    id_lens = sum((w for _, w in rendered),
                  np.zeros(R, np.int64))
    rec_off = np.cumsum(id_lens) - id_lens
    out = np.empty(int(id_lens.sum()), np.uint8)
    prefix = rec_off
    for flat, w in rendered:
        if not native.scatter(flat, prefix, w, out):
            return NotImplemented
        prefix = prefix + w
    raw = out.tobytes()
    # LazyLines: downstream (assemble_block, raw_len accounting, pipe-out)
    # consumes the concatenated form; R small bytes objects materialize
    # only if someone indexes
    from fastqueeze_tpu_torch.io.fastq import LazyLines
    offs = np.concatenate(([0], np.cumsum(id_lens, dtype=np.int64)))
    return LazyLines(raw, offs)


def reconstruct_ids(schema: IdBinSchema, n_reads: int,
                    var_payload: bytes) -> List[bytes]:
    """Inverse of analyze_ids."""
    if n_reads == 0:
        return []
    if n_reads > 2048:
        out = _reconstruct_ids_vec(schema, n_reads, var_payload)
        if out is not NotImplemented:
            return out
    # split var payload back into per-field columns
    var_cols: List[List[bytes]] = []
    lines = var_payload.split(b"\n")[:-1] if var_payload else []
    pos = 0
    for f in schema.fields:
        if f["m"] in (MODE_TEXT_VAR, MODE_NUM_VAR):
            var_cols.append(lines[pos:pos + n_reads])
            pos += n_reads
    out = []
    vi_base = 0
    # precompute per-field generators
    rendered: List[List[bytes]] = []
    vi = 0
    for f in schema.fields:
        m = f["m"]
        if m in (MODE_TEXT_CONST, MODE_NUM_CONST):
            v = f["v"].encode("latin1")
            rendered.append([v] * n_reads)
        elif m == MODE_NUM_DELTA:
            s, d = f["s"], f["d"]
            rendered.append([str(s + d * k).encode() for k in range(n_reads)])
        elif m == MODE_NUM_DELTA2:
            s1, s2, d = f["s"], f["s2"], f["d"]
            rendered.append([str((s1 if k % 2 == 0 else s2) + d * (k // 2))
                             .encode() for k in range(n_reads)])
        elif m == MODE_NUM_VAR:
            deltas = [int(x) for x in var_cols[vi]]
            vi += 1
            vals, acc = [], 0
            for d in deltas:
                acc += d
                vals.append(acc)
            rendered.append([str(v).encode() for v in vals])
        else:  # MODE_TEXT_VAR
            rendered.append(var_cols[vi])
            vi += 1
    for k in range(n_reads):
        out.append(b"".join(col[k] for col in rendered))
    return out
