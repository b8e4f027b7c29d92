"""IGES (.igs) import/export: rational B-spline surfaces (entity 128)
and curves (entity 126).

Port of goldfish_tpu/geometry/igs_io.py, host NumPy, unchanged in what it
computes.

Replaces the reference's pythonOCC path `read_igs_file` +
`topoface2surface` (reference: demos usage at
demos_om/thickness_opt/plate/plate_var_th_opt_wint.py:230-233; the
PENGoLINS helpers wrap OpenCASCADE's IGES processor). Parses the IGES
file format directly (spec: USPRO/IGES 5.3): fixed 80-column records,
Start/Global/Directory/Parameter/Terminate sections; entity types 128
(rational B-spline surface) and 126 (rational B-spline curve) are
materialized — the surfaces are what the shell pipeline consumes,
the curves carry intersection/trim polylines when a CAD system
exported them. Returns geometry/nurbs.NURBS objects (curves are NURBS
with one knot vector).
"""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np

from goldfish_tpu_torch.geometry.nurbs import NURBS

__all__ = ["read_igs_file", "read_igs_curves", "read_igs_trimmed",
           "TrimmedSurface", "write_igs_file"]


def _parse_free_format(text: str, pdelim: str, rdelim: str):
    """Split an IGES free-format parameter string into tokens, handling
    nH Hollerith strings."""
    toks = []
    i = 0
    n = len(text)
    cur = ""
    while i < n:
        c = text[i]
        if c == "H" and cur.strip().isdigit():
            k = int(cur.strip())
            toks.append(text[i + 1: i + 1 + k])
            i += k + 1
            cur = ""
            # skip to next delimiter
            while i < n and text[i] not in (pdelim, rdelim):
                i += 1
            i += 1
            continue
        if c == pdelim or c == rdelim:
            toks.append(cur.strip())
            cur = ""
            i += 1
            if c == rdelim:
                break
            continue
        cur += c
        i += 1
    if cur.strip():
        toks.append(cur.strip())
    return toks


def _num(tok: str) -> float:
    tok = tok.strip()
    if not tok:
        return 0.0
    # IGES allows D exponents
    return float(tok.replace("D", "E").replace("d", "e"))


def _parse_entities_de(path: str) -> dict:
    """Parse into {DE index (odd, 1-based): (etype, parameter tokens)}
    so pointer-carrying entities (102/142/144) can be resolved."""
    out = {}
    for de, etype, toks, _status in _parse_entities_raw(path):
        out[de] = (etype, toks)
    return out


def _parse_entities(path: str):
    """Yield (etype, parameter tokens) for every directory entity."""
    return [(etype, toks)
            for _, etype, toks, _status in _parse_entities_raw(path)]


def _subordinate(status: str) -> int:
    """Subordinate-entity switch of a DE status field (2nd 2-digit
    subfield; 01/03 = physically dependent, e.g. trim-structure
    entities)."""
    try:
        return int(status[2:4])
    except (ValueError, IndexError):
        return 0


def _parse_entities_raw(path: str):
    """Yield (de_index, etype, parameter tokens) for every entity."""
    with open(path, "r", errors="replace") as f:
        raw = f.read().splitlines()

    glob_lines, dir_lines, par_lines = [], [], []
    for line in raw:
        if len(line) < 73:
            line = line.ljust(80)
        sec = line[72]
        if sec == "G":
            glob_lines.append(line[:72])
        elif sec == "D":
            dir_lines.append(line[:72])
        elif sec == "P":
            par_lines.append(line)

    # global section: first two parameters are the delimiters
    gtext = "".join(glob_lines)
    pdelim, rdelim = ",", ";"
    if gtext.startswith(","):
        pdelim = ","
        rest = gtext[1:]
    else:
        m = re.match(r"^1H(.)", gtext)
        if m:
            pdelim = m.group(1)
            rest = gtext[4:]
        else:
            rest = gtext
    if rest.startswith(pdelim):
        rdelim = ";"
    else:
        m = re.match(r"^1H(.)", rest)
        if m:
            rdelim = m.group(1)

    # directory entries: two 72-col lines each; field 1 = entity type,
    # field 2 = parameter data pointer (1-based P line index), field 9
    # (cols 65-72 of line 1) = status (blank/subordinate/use/hierarchy
    # 2-digit subfields)
    entities = []
    for i in range(0, len(dir_lines) - 1, 2):
        l1 = dir_lines[i]
        etype = int(l1[0:8])
        pstart = int(l1[8:16])
        status = l1[64:72]
        entities.append((etype, pstart, status))

    # parameter section: group lines by their directory back-pointer
    # (cols 66-72 of P lines), concatenating cols 1-64
    pdata: dict[int, str] = {}
    for line in par_lines:
        dptr = int(line[64:72].replace("P", " ").split()[0]) \
            if line[64:72].strip() else 0
        pdata.setdefault(dptr, "")
        pdata[dptr] += line[:64]

    # directory back-pointer on P lines is the DE index (odd, 1-based)
    out = []
    for k, (etype, pstart, status) in enumerate(entities):
        de_index = 2 * k + 1
        text = pdata.get(de_index)
        if text is None:
            continue
        out.append((de_index, etype,
                    _parse_free_format(text, pdelim, rdelim), status))
    return out


def _surface_from_toks(toks) -> NURBS:
    if int(_num(toks[0])) != 128:
        raise ValueError(f"expected entity 128, got {toks[0]}")
    K1, K2 = int(_num(toks[1])), int(_num(toks[2]))
    M1, M2 = int(_num(toks[3])), int(_num(toks[4]))
    # toks[5:10]: PROP1..5 flags (closed/polynomial/periodic)
    n1, n2 = K1 + 1, K2 + 1      # control point counts
    nk1 = n1 + M1 + 1            # knot counts
    nk2 = n2 + M2 + 1
    i0 = 10
    S = np.array([_num(t) for t in toks[i0: i0 + nk1]])
    i0 += nk1
    T = np.array([_num(t) for t in toks[i0: i0 + nk2]])
    i0 += nk2
    W = np.array([_num(t) for t in toks[i0: i0 + n1 * n2]])
    i0 += n1 * n2
    P = np.array([_num(t) for t in toks[i0: i0 + 3 * n1 * n2]])
    i0 += 3 * n1 * n2
    # IGES orders control points with the FIRST index fastest:
    # P(i,j), i = 0..K1 inner, j = 0..K2 outer
    W = W.reshape(n2, n1).T              # -> (n1, n2)
    P = P.reshape(n2, n1, 3).transpose(1, 0, 2)
    ctrl = np.concatenate([P * W[..., None], W[..., None]], axis=-1)
    return NURBS([S, T], ctrl)


def _curve_from_toks(toks) -> NURBS:
    if int(_num(toks[0])) != 126:
        raise ValueError(f"expected entity 126, got {toks[0]}")
    K, M = int(_num(toks[1])), int(_num(toks[2]))
    # toks[3:7]: PROP1..4 (planar/closed/polynomial/periodic)
    n = K + 1
    nk = n + M + 1
    i0 = 7
    T = np.array([_num(t) for t in toks[i0: i0 + nk]])
    i0 += nk
    W = np.array([_num(t) for t in toks[i0: i0 + n]])
    i0 += n
    P = np.array([_num(t) for t in toks[i0: i0 + 3 * n]]).reshape(n, 3)
    ctrl = np.concatenate([P * W[:, None], W[:, None]], axis=-1)
    return NURBS([T], ctrl)


def read_igs_file(path: str) -> list[NURBS]:
    """Parse all type-128 entities into NURBS surfaces.

    Type-144 (trimmed surface) wrappers are honored only in their
    trivial form (N1=0, no inner loops — the whole natural domain,
    which is all the reference corpus contains: the plate file's six
    `144,<de>,0,0,0;` entities). A 144 with real trimming raises a
    warning — the shell pipeline quadratures the full patch domain."""
    import warnings

    entities = _parse_entities(path)
    for etype, toks in entities:
        if etype == 144:
            n1 = int(_num(toks[2])) if len(toks) > 2 else 0
            n2 = int(_num(toks[3])) if len(toks) > 3 else 0
            if n1 != 0 or n2 != 0:
                warnings.warn(
                    f"{path}: IGES type-144 entity carries a "
                    "non-trivial trim (outer/inner boundary curves); "
                    "read_igs_file ignores it — use read_igs_trimmed "
                    "+ build_patch_stack(trims=...) for finite-cell "
                    "trimmed quadrature.", stacklevel=2)
    return [_surface_from_toks(toks)
            for etype, toks in entities if etype == 128]


def read_igs_curves(path: str) -> list[NURBS]:
    """Parse all INDEPENDENT type-126 entities into NURBS curves (one
    knot vector, homogeneous control points) — trim/intersection
    curves a CAD export carries alongside the surfaces. Subordinate
    126s (physically dependent trim-loop constituents, DE status
    subfield 2) are excluded — those belong to `read_igs_trimmed`."""
    return [_curve_from_toks(toks)
            for _, etype, toks, status in _parse_entities_raw(path)
            if etype == 126 and _subordinate(status) == 0]


class TrimmedSurface(NamedTuple):
    """A type-144 trimmed surface: the base NURBS patch plus trim
    loops as PARAMETER-SPACE curves (x, y of the curve = u, v of the
    surface; IGES type-142 'curve on parametric surface' convention).
    outer=None means the natural domain boundary (N1=0)."""

    surf: NURBS
    outer: list[NURBS] | None
    inner: list[list[NURBS]]


def _resolve_pcurve(de: int, ents: dict) -> list[NURBS]:
    """Resolve a DE pointer to a list of parameter-space curves:
    126 (B-spline), 110 (line), 100 (circular arc, exact rational
    quadratic) or 102 (composite — concatenation of constituents)."""
    etype, toks = ents[de]
    if etype == 126:
        return [_curve_from_toks(toks)]
    if etype == 110:
        P = np.array([[_num(t) for t in toks[1:4]],
                      [_num(t) for t in toks[4:7]]])
        return [NURBS([np.array([0.0, 0.0, 1.0, 1.0])], P)]
    if etype == 100:
        # (ZT, X1, Y1 center, X2, Y2 start, X3, Y3 end), CCW
        import math

        from goldfish_tpu_torch.geometry.cadkit import circle

        cx, cy = _num(toks[2]), _num(toks[3])
        sx, sy = _num(toks[4]), _num(toks[5])
        ex, ey = _num(toks[6]), _num(toks[7])
        r = math.hypot(sx - cx, sy - cy)
        t0 = math.atan2(sy - cy, sx - cx)
        t1 = math.atan2(ey - cy, ex - cx)
        if t1 <= t0 + 1e-14:
            t1 += 2.0 * math.pi
        return [circle(center=(cx, cy, 0.0), radius=r, angle=(t0, t1))]
    if etype == 102:
        n = int(_num(toks[1]))
        ptrs = [int(_num(t)) for t in toks[2: 2 + n]]
        out = []
        for p in ptrs:
            out.extend(_resolve_pcurve(p, ents))
        return out
    raise ValueError(
        f"unsupported trim-curve entity type {etype} at DE {de}")


def _loop_from_142(de: int, ents: dict) -> list[NURBS] | None:
    """Resolve a type-142 curve-on-surface to its parameter-space
    curve list (BPTR). Returns None when only the model-space curve is
    present (BPTR=0) — recovering (u, v) then needs surface inversion,
    which this reader does not attempt."""
    etype, toks = ents[de]
    if etype != 142:
        raise ValueError(f"expected 142 at DE {de}, got {etype}")
    # params: CRTN, SPTR (surface), BPTR (param-space curve), CPTR, PREF
    bptr = int(_num(toks[3]))
    if bptr == 0:
        import warnings

        warnings.warn(
            f"IGES 142 at DE {de} has no parameter-space curve "
            "(BPTR=0); the loop is ignored.", stacklevel=3)
        return None
    return _resolve_pcurve(bptr, ents)


def read_igs_trimmed(path: str) -> list[TrimmedSurface]:
    """Parse type-144 trimmed surfaces with their trim loops resolved
    to parameter-space NURBS curves (via 142 -> 102/126/110). Surfaces
    not wrapped in a 144 are returned untrimmed. The loops feed
    geometry/trim.apply_trim / build_patch_stack(trims=...) —
    finite-cell quadrature masking replaces the reference's OCC face
    handling (reference role: igakit/OCC preprocessing in
    PENGoLINS, SURVEY.md section 2.4)."""
    import warnings

    ents = _parse_entities_de(path)
    # resolve every 144 first, keyed by its surface's DE so the output
    # preserves the FILE's surface order (read_igs_file order — BCs,
    # materials and interface specs are keyed by patch index)
    trim_by_surf: dict[int, TrimmedSurface] = {}
    for de in sorted(ents):
        etype, toks = ents[de]
        if etype != 144:
            continue
        pts = int(_num(toks[1]))
        if pts not in ents or ents[pts][0] != 128:
            warnings.warn(
                f"{path}: IGES 144 at DE {de} wraps an unsupported "
                f"surface type "
                f"{ents[pts][0] if pts in ents else '?'} — skipped.",
                stacklevel=2)
            continue
        try:
            n1 = int(_num(toks[2]))
            n2 = int(_num(toks[3]))
            pto = int(_num(toks[4])) if len(toks) > 4 else 0
            ptis = [int(_num(t)) for t in toks[5: 5 + n2]]
            surf = _surface_from_toks(ents[pts][1])
            outer = None
            if n1 != 0 and pto != 0:
                outer = _loop_from_142(pto, ents)
            inner = [lp for lp in
                     (_loop_from_142(p, ents) for p in ptis)
                     if lp is not None]
            trim_by_surf[pts] = TrimmedSurface(surf, outer, inner)
        except Exception as e:  # degrade like read_igs_file does
            warnings.warn(
                f"{path}: could not resolve the trim of the IGES 144 "
                f"at DE {de} ({e}); the surface is used UNTRIMMED.",
                stacklevel=2)
            trim_by_surf[pts] = TrimmedSurface(
                _surface_from_toks(ents[pts][1]), None, [])
    out = []
    for de in sorted(ents):
        etype, toks = ents[de]
        if etype != 128:
            continue
        out.append(trim_by_surf.get(
            de, TrimmedSurface(_surface_from_toks(toks), None, [])))
    return out


def write_igs_file(path: str, surfs: list[NURBS], author="goldfish_tpu",
                   curves: list[NURBS] | None = None, trims=None):
    """Write NURBS surfaces as IGES type-128 entities and (optionally)
    NURBS curves as type-126 entities (the reverse of `read_igs_file` /
    `read_igs_curves`; the reference relies on OCC for IGES output —
    reference role: pythonOCC write paths used by the eVTOL workflow,
    SURVEY.md section 2.4). Round-trips exactly with this module's
    reader.

    trims: optional per-surface list (None entries = untrimmed) of
    `(outer, inners)` where outer is a list of parameter-space NURBS
    curves (or None for the natural domain) and inners a list of such
    loops — emitted as 144 (trimmed surface) + 142 (curve on surface)
    + 102/126 entities, the inverse of `read_igs_trimmed`."""

    def fmt(x):
        return f"{float(x):.17G}"

    # ---- parameter records: (etype, text, status) per entity; add()
    # returns the record's DE index so pointer entities (102/142/144)
    # can reference earlier records. Trim-structure constituents are
    # marked physically SUBORDINATE (status subfield 2 = 01) so
    # read_igs_curves does not mix them into model-curve output ----
    records = []

    def add(etype, toks, status="00000000"):
        records.append((etype, ",".join(toks) + ";", status))
        return 2 * (len(records) - 1) + 1

    def curve_toks(c):
        (n,) = c.shape
        (p,) = c.degree
        W = c.weights
        P = c.points
        poly = "1" if np.all(np.abs(W - W.ravel()[0]) <= 1e-14) else "0"
        toks = ["126", str(n - 1), str(p), "0", "0", poly, "0"]
        toks += [fmt(x) for x in c.knots[0]]
        toks += [fmt(x) for x in W.ravel()]
        toks += [fmt(x) for x in P.ravel()]
        toks += [fmt(c.knots[0][0]), fmt(c.knots[0][-1]),
                 "0", "0", "0"]  # param range + (unused) planar normal
        return toks

    SUB = "00010500"  # subordinate=01, use=05 (2D parametric)

    def add_loop(loop, de_s):
        """Emit one trim loop (list of param-space curves) as
        126[+102]+142; return the 142's DE."""
        loop = [loop] if isinstance(loop, NURBS) else list(loop)
        des = [add(126, curve_toks(c), SUB) for c in loop]
        de_b = des[0] if len(des) == 1 else add(
            102, ["102", str(len(des))] + [str(d) for d in des], SUB)
        # CRTN=0 (unspecified), SPTR, BPTR, CPTR=0, PREF=1 (B given)
        return add(142, ["142", "0", str(de_s), str(de_b), "0", "1"],
                   SUB)

    for i, s in enumerate(surfs):
        n1, n2 = s.shape
        p1, p2 = s.degree
        W = s.weights
        P = s.points
        toks = ["128", str(n1 - 1), str(n2 - 1), str(p1), str(p2),
                "0", "0", "0" if np.any(np.abs(W - W.ravel()[0]) > 1e-14)
                else "1", "0", "0"]
        toks += [fmt(x) for x in s.knots[0]]
        toks += [fmt(x) for x in s.knots[1]]
        # first index fastest (IGES convention)
        toks += [fmt(x) for x in W.T.ravel()]
        toks += [fmt(x) for x in P.transpose(1, 0, 2).ravel()]
        toks += [fmt(s.knots[0][0]), fmt(s.knots[0][-1]),
                 fmt(s.knots[1][0]), fmt(s.knots[1][-1])]
        de_s = add(128, toks)
        tr = trims[i] if trims is not None else None
        if tr is not None:
            outer, inners = tr
            de_o = 0 if outer is None else add_loop(outer, de_s)
            de_is = [add_loop(lp, de_s) for lp in (inners or [])]
            add(144, ["144", str(de_s),
                      "0" if outer is None else "1",
                      str(len(de_is)), str(de_o)]
                + [str(d) for d in de_is])
    for c in (curves or []):
        add(126, curve_toks(c))

    # ---- assemble sections ----
    start = ["goldfish_tpu IGES export".ljust(72) + "S0000001"]
    gparams = [",", ";", f"{len(author)}H{author}", "7Hgoldfish",
               "16Hgoldfish_tpu_igs", "32", "308", "15", "308", "15",
               "7Hgoldfish", "1.0", "2", "2HMM", "1", "0.001",
               "15H20260101.000000", "1E-9", "1000.0", f"{len(author)}H"
               f"{author}", "7Hgoldfish", "11", "0",
               "15H20260101.000000"]
    gtext = ",".join(gparams) + ";"
    glob_lines = []
    while gtext:
        glob_lines.append(gtext[:72])
        gtext = gtext[72:]
    glob = [ln.ljust(72) + f"G{i + 1:07d}"
            for i, ln in enumerate(glob_lines)]

    dir_lines = []
    par_lines = []
    pline_no = 1
    for k, (etype, rec, status) in enumerate(records):
        de = 2 * k + 1
        chunks = [rec[i:i + 64] for i in range(0, len(rec), 64)]
        pstart = pline_no
        for ch in chunks:
            par_lines.append(
                ch.ljust(64) + f"{de:8d}".replace(" ", " ")[:8]
                + f"P{pline_no:07d}")
            pline_no += 1
        d1 = (f"{etype:8d}{pstart:8d}{0:8d}{0:8d}{0:8d}{0:8d}{0:8d}"
              f"{0:8d}{status}").ljust(72) + f"D{de:07d}"
        d2 = (f"{etype:8d}{0:8d}{0:8d}{len(chunks):8d}{0:8d}"
              + " " * 32).ljust(72) + f"D{de + 1:07d}"
        dir_lines.extend([d1, d2])

    term = (f"S{1:7d}G{len(glob):7d}D{len(dir_lines):7d}"
            f"P{len(par_lines):7d}").ljust(72) + "T0000001"
    with open(path, "w") as f:
        f.write("\n".join(start + glob + dir_lines + par_lines
                          + [term]) + "\n")
