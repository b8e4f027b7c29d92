"""STEP (ISO 10303-21) B-spline surface import/export.

Port of goldfish_tpu/geometry/step_io.py, host NumPy, unchanged in what it
computes.

The reference reaches STEP geometry through pythonOCC
(`read_stp_file`/CADDEE's c172.stp prologue; reference usage:
demos_om/shape_opt/eVTOL/
evtol_wing_shape_thickness_opt_wint.py prologue, SURVEY.md section
3.3). This module parses Part-21 files natively: every
B_SPLINE_SURFACE_WITH_KNOTS entity — plain or inside a complex
(rational) entity with RATIONAL_B_SPLINE_SURFACE weights — becomes a
NURBS surface, with knot vectors normalized ("reparametrized") to
[0, 1]. `write_step_file` emits the same subset and round-trips
exactly with the reader.
"""

from __future__ import annotations

import re

import numpy as np

from goldfish_tpu_torch.geometry.nurbs import NURBS

__all__ = ["read_step_file", "write_step_file",
           "read_step_assembly", "write_step_assembly",
           "transform_surface",
           "reparametrize_surfaces", "refine_surfaces"]


def _split_entities(text: str) -> dict[int, str]:
    """#id = BODY ; records of the DATA section."""
    m = re.search(r"DATA\s*;(.*?)ENDSEC\s*;", text,
                  re.DOTALL | re.IGNORECASE)
    data = m.group(1) if m else text
    out = {}
    for stmt in re.split(r";\s*", data):
        stmt = stmt.strip()
        mm = re.match(r"#(\d+)\s*=\s*(.*)", stmt, re.DOTALL)
        if mm:
            out[int(mm.group(1))] = mm.group(2).strip()
    return out


def _tokenize(body: str):
    """Parse a STEP argument list into nested Python lists."""
    pos = [0]

    def parse_list():
        if body[pos[0]] != "(":
            raise ValueError("STEP record: expected '('")
        pos[0] += 1
        items = []
        buf = ""
        while pos[0] < len(body):
            c = body[pos[0]]
            if c == "(":
                items.append(parse_list())
            elif c == ")":
                if buf.strip():
                    items.append(buf.strip())
                pos[0] += 1
                return items
            elif c == ",":
                if buf.strip():
                    items.append(buf.strip())
                buf = ""
                pos[0] += 1
            elif c == "'":
                # string literal
                j = body.index("'", pos[0] + 1)
                buf += body[pos[0]: j + 1]
                pos[0] = j + 1
            else:
                buf += c
                pos[0] += 1
        raise ValueError("unbalanced parens in STEP record")

    i = body.index("(")
    pos[0] = i
    return parse_list()


def _num(tok):
    return float(tok)


def _surface_from_args(args, weights_args, points_of):
    """args: B_SPLINE_SURFACE_WITH_KNOTS argument list (name, degu,
    degv, cp-grid, form, 3 flags, umult, vmult, uknots, vknots, ...);
    complex rational entities drop the leading name/degree args into
    separate sub-records, handled by the caller."""
    deg_u = int(args[1])
    deg_v = int(args[2])
    grid = args[3]
    mult_u = [int(x) for x in args[8]]
    mult_v = [int(x) for x in args[9]]
    knot_u = [float(x) for x in args[10]]
    knot_v = [float(x) for x in args[11]]

    P = np.array([[points_of(ref) for ref in row] for row in grid])
    n_u, n_v = P.shape[0], P.shape[1]
    U = np.repeat(knot_u, mult_u)
    V = np.repeat(knot_v, mult_v)
    if len(U) != n_u + deg_u + 1 or len(V) != n_v + deg_v + 1:
        raise ValueError(f"STEP surface: knots ({len(U)}, {len(V)}) for "
                         f"{n_u} x {n_v} points of degree ({deg_u}, "
                         f"{deg_v})")
    # reparametrize to [0, 1]
    U = (U - U[0]) / (U[-1] - U[0])
    V = (V - V[0]) / (V[-1] - V[0])

    if weights_args is not None:
        W = np.array([[float(x) for x in row] for row in weights_args])
    else:
        W = np.ones((n_u, n_v))
    ctrl = np.concatenate([P * W[..., None], W[..., None]], axis=-1)
    return NURBS([U, V], ctrl)


def _parse_surfaces(ents):
    """(cartesian-point dict, {entity id: NURBS}) for every plain or
    complex (rational) B-spline surface entity."""
    pts: dict[int, np.ndarray] = {}
    for eid, body in ents.items():
        if body.upper().startswith("CARTESIAN_POINT"):
            args = _tokenize(body)
            pts[eid] = np.array([_num(x) for x in args[1]])

    def points_of(ref):
        return pts[int(str(ref).lstrip("#"))]

    surf_of: dict[int, NURBS] = {}
    for eid, body in sorted(ents.items()):
        up = body.upper()
        if up.startswith("B_SPLINE_SURFACE_WITH_KNOTS"):
            args = _tokenize(body)
            surf_of[eid] = _surface_from_args(args, None, points_of)
        elif up.startswith("(") and "B_SPLINE_SURFACE_WITH_KNOTS" in up:
            # complex (usually rational) entity: sub-records
            # B_SPLINE_SURFACE(deg_u, deg_v, grid, ...) +
            # B_SPLINE_SURFACE_WITH_KNOTS(mults/knots) +
            # RATIONAL_B_SPLINE_SURFACE(weights)
            subs = _split_complex(body)
            base = subs.get("B_SPLINE_SURFACE")
            wk = subs.get("B_SPLINE_SURFACE_WITH_KNOTS")
            rat = subs.get("RATIONAL_B_SPLINE_SURFACE")
            if not (base and wk):
                continue
            bargs = _tokenize(base)
            kargs = _tokenize(wk)
            wargs = _tokenize(rat)[0] if rat else None
            # reassemble into the plain-args layout
            args = ["''", bargs[0], bargs[1], bargs[2],
                    None, None, None, None,
                    kargs[0], kargs[1], kargs[2], kargs[3]]
            surf_of[eid] = _surface_from_args(args, wargs, points_of)
    return pts, surf_of


def read_step_file(path: str) -> list[NURBS]:
    """All B-spline surfaces of a STEP Part-21 file, knots normalized
    to [0, 1]."""
    with open(path, "r", errors="replace") as f:
        text = f.read()
    _, surf_of = _parse_surfaces(_split_entities(text))
    return [surf_of[k] for k in sorted(surf_of)]


def _split_complex(body: str) -> dict[str, str]:
    """Split a complex entity '(NAME1(args)NAME2(args)...)' into
    {NAME: '(args)'} with proper paren balancing (the sub-record names
    prefix-collide: B_SPLINE_SURFACE vs B_SPLINE_SURFACE_WITH_KNOTS)."""
    inner = body.strip()
    if not inner.startswith("("):
        raise ValueError("STEP complex entity: expected '('")
    inner = inner[1:-1] if inner.endswith(")") else inner[1:]
    out = {}
    i = 0
    n = len(inner)
    while i < n:
        while i < n and not (inner[i].isalpha() or inner[i] == "_"):
            i += 1
        j = i
        while j < n and (inner[j].isalnum() or inner[j] == "_"):
            j += 1
        name = inner[i:j]
        if j >= n or inner[j] != "(":
            i = j + 1
            continue
        depth = 0
        k = j
        while k < n:
            if inner[k] == "(":
                depth += 1
            elif inner[k] == ")":
                depth -= 1
                if depth == 0:
                    break
            elif inner[k] == "'":
                k = inner.index("'", k + 1)
            k += 1
        out[name] = inner[j:k + 1]
        i = k + 1
    return out


def _header_lines(name):
    return ["ISO-10303-21;", "HEADER;",
            f"FILE_DESCRIPTION(('{name}'),'2;1');",
            f"FILE_NAME('{name}.stp','2026-01-01',('{name}'),(''),"
            "'goldfish_tpu','goldfish_tpu','');",
            "FILE_SCHEMA(('AUTOMOTIVE_DESIGN'));", "ENDSEC;", "DATA;"]


def _emit_surface(add, s: NURBS) -> int:
    """Emit CARTESIAN_POINT grid + the (rational, complex-entity)
    B-spline surface record via add(body) -> eid; returns the surface
    entity id. Shared by write_step_file and write_step_assembly."""
    n_u, n_v = s.shape
    p_u, p_v = s.degree
    P, W = s.points, s.weights
    grid_refs = []
    for i in range(n_u):
        row = []
        for j in range(n_v):
            pid = add(f"CARTESIAN_POINT('',({P[i, j, 0]:.17G},"
                      f"{P[i, j, 1]:.17G},{P[i, j, 2]:.17G}))")
            row.append(f"#{pid}")
        grid_refs.append("(" + ",".join(row) + ")")
    grid = "(" + ",".join(grid_refs) + ")"

    def knot_fields(knots):
        vals, mults = [], []
        for k in knots:
            if vals and abs(k - vals[-1]) < 1e-14:
                mults[-1] += 1
            else:
                vals.append(float(k))
                mults.append(1)
        return ("(" + ",".join(str(m) for m in mults) + ")",
                "(" + ",".join(f"{v:.17G}" for v in vals) + ")")

    mu, ku = knot_fields(s.knots[0])
    mv, kv = knot_fields(s.knots[1])
    wtxt = "(" + ",".join(
        "(" + ",".join(f"{W[i, j]:.17G}" for j in range(n_v)) + ")"
        for i in range(n_u)) + ")"
    return add(
        f"(BOUNDED_SURFACE()B_SPLINE_SURFACE({p_u},{p_v},{grid},"
        f".UNSPECIFIED.,.F.,.F.,.F.)"
        f"B_SPLINE_SURFACE_WITH_KNOTS({mu},{mv},{ku},{kv},"
        f".UNSPECIFIED.)GEOMETRIC_REPRESENTATION_ITEM()"
        f"RATIONAL_B_SPLINE_SURFACE({wtxt})REPRESENTATION_ITEM('')"
        f"SURFACE())")


def write_step_file(path: str, surfs: list[NURBS],
                    name: str = "goldfish_tpu"):
    """Emit the surfaces as (rational, complex-entity) STEP B-spline
    surfaces. Round-trips with `read_step_file`."""
    lines = _header_lines(name)
    eid = [1]

    def add(body):
        lines.append(f"#{eid[0]}={body};")
        eid[0] += 1
        return eid[0] - 1

    for s in surfs:
        _emit_surface(add, s)
    lines += ["ENDSEC;", "END-ISO-10303-21;"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------
# assemblies: AXIS2_PLACEMENT_3D / ITEM_DEFINED_TRANSFORMATION /
# REPRESENTATION_RELATIONSHIP_WITH_TRANSFORMATION instancing
# (reference role: OCC's STEP assembly resolution inside
# `read_stp_file`; SURVEY.md section 2.4)
# ---------------------------------------------------------------------


def transform_surface(s: NURBS, R: np.ndarray, t: np.ndarray) -> NURBS:
    """Rigidly place a NURBS surface: points' = R @ p + t (weights
    unchanged — rigid maps commute with the projective weights)."""
    P = s.points @ np.asarray(R, dtype=np.float64).T + np.asarray(
        t, dtype=np.float64)
    W = s.weights[..., None]
    return NURBS(list(s.knots), np.concatenate([P * W, W], axis=-1))


def _ref(tok) -> int:
    return int(str(tok).lstrip("#"))


def _axis_frame(eid, ents, pts):
    """AXIS2_PLACEMENT_3D -> (M 3x3, origin): columns of M are the
    placement's x, y, z axes (z = axis, x = ref_direction orthogonalized
    against z, y = z cross x; defaults per ISO 10303-42)."""
    args = _tokenize(ents[eid])
    origin = pts[_ref(args[1])]
    z = np.array([0.0, 0.0, 1.0])
    x = np.array([1.0, 0.0, 0.0])
    if len(args) > 2 and str(args[2]).startswith("#"):
        z = _dir_of(_ref(args[2]), ents)
    if len(args) > 3 and str(args[3]).startswith("#"):
        x = _dir_of(_ref(args[3]), ents)
    z = z / np.linalg.norm(z)
    x = x - np.dot(x, z) * z
    nx = np.linalg.norm(x)
    if nx < 1e-12:
        # ref_direction omitted/parallel to the axis: ISO 10303-42
        # allows any non-parallel default — derive one
        alt = np.array([0.0, 1.0, 0.0]) if abs(z[0]) > 0.9 \
            else np.array([1.0, 0.0, 0.0])
        x = alt - np.dot(alt, z) * z
        nx = np.linalg.norm(x)
    x = x / nx
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1), origin


def _dir_of(eid, ents):
    args = _tokenize(ents[eid])
    return np.array([float(v) for v in args[1]])


def _strip_str(tok) -> str:
    return str(tok).strip().strip("'")


def _product_graph(ents):
    """AP203/AP214 product structure of a STEP file:

      PRODUCT -> PRODUCT_DEFINITION_FORMATION* -> PRODUCT_DEFINITION
      PRODUCT_DEFINITION_SHAPE(pd) + SHAPE_DEFINITION_REPRESENTATION
        ties a product definition to its SHAPE_REPRESENTATION;
      NEXT_ASSEMBLY_USAGE_OCCURRENCE(parent_pd, child_pd) is one
        instance of child in parent;
      CONTEXT_DEPENDENT_SHAPE_REPRESENTATION(rep_relationship,
        PRODUCT_DEFINITION_SHAPE(nauo)) ties a placement relationship
        to its occurrence.

    Returns (prod_of_rep: rep eid -> product name,
             rr_occurrence: relationship eid -> (parent_rep, child_rep,
             occurrence name)). Both empty for files without product
    records (the reference reads such files through OCC, which applies
    the same resolution; SURVEY.md section 2.4 pythonOCC row)."""
    prod_name, pdf_prod, pd_pdf = {}, {}, {}
    pds_def, sdr, nauo, cdsr = {}, [], {}, {}
    for eid, body in ents.items():
        up = body.upper()
        if re.match(r"PRODUCT\s*\(", up):
            a = _tokenize(body)
            prod_name[eid] = _strip_str(a[1]) or _strip_str(a[0])
        elif up.startswith("PRODUCT_DEFINITION_FORMATION"):
            pdf_prod[eid] = _ref(_tokenize(body)[2])
        elif re.match(r"PRODUCT_DEFINITION\s*\(", up):
            pd_pdf[eid] = _ref(_tokenize(body)[2])
        elif up.startswith("PRODUCT_DEFINITION_SHAPE"):
            pds_def[eid] = _ref(_tokenize(body)[2])
        elif up.startswith("SHAPE_DEFINITION_REPRESENTATION"):
            a = _tokenize(body)
            sdr.append((_ref(a[0]), _ref(a[1])))
        elif up.startswith("NEXT_ASSEMBLY_USAGE_OCCURRENCE"):
            a = _tokenize(body)
            nauo[eid] = (_ref(a[3]), _ref(a[4]), _strip_str(a[1]))
        elif up.startswith("CONTEXT_DEPENDENT_SHAPE_REPRESENTATION"):
            a = _tokenize(body)
            cdsr[_ref(a[0])] = _ref(a[1])

    pd_name = {pd: prod_name.get(pdf_prod.get(pdf, -1), "")
               for pd, pdf in pd_pdf.items()}
    rep_of_pd, prod_of_rep = {}, {}
    for pds, rep in sdr:
        de = pds_def.get(pds)
        if de in pd_name:
            rep_of_pd[de] = rep
            prod_of_rep[rep] = pd_name[de]

    rr_occurrence = {}
    for rr, pds in cdsr.items():
        n = nauo.get(pds_def.get(pds, -1))
        if n is None:
            continue
        ppd, cpd, occ = n
        prep, crep = rep_of_pd.get(ppd), rep_of_pd.get(cpd)
        if prep is not None and crep is not None:
            rr_occurrence[rr] = (prep, crep, occ)
    return prod_of_rep, rr_occurrence


def read_step_assembly(path: str, with_structure: bool = False):
    """All B-spline surfaces of a STEP file with assembly placements
    APPLIED: ITEM_DEFINED_TRANSFORMATION entities referenced from
    (SHAPE_)REPRESENTATION_RELATIONSHIP_WITH_TRANSFORMATION records
    place each child representation's surfaces into its parent frame
    (composed recursively through nested sub-assemblies). Surfaces not
    contained in any representation — or in files without relationship
    records — come through at identity, so this is a strict superset of
    `read_step_file` output semantics.

    Rep orientation: when the file carries product structure
    (NEXT_ASSEMBLY_USAGE_OCCURRENCE + CONTEXT_DEPENDENT_SHAPE_
    REPRESENTATION, the AP203/AP214 norm and what OCC consults), the
    occurrence's (parent_pd, child_pd) decides which representation is
    the parent — exporter rep_1/rep_2 order does not matter, and a
    swapped order also inverts the transformation. Without product
    records the reader falls back to the rep_1 = child convention
    `write_step_assembly` emits; a file whose relationships resolve to
    nothing falls back to the un-instanced masters with a warning.

    `with_structure=True` returns `(surfaces, meta)` where `meta[i]` is
    `{"product": <owning PRODUCT name or None>, "path": <tuple of
    occurrence/product names from the root to the instance>}` — the
    product-structure metadata OCC exposes as the document label tree
    for the reference's CAD imports."""
    with open(path, "r", errors="replace") as f:
        text = f.read()
    ents = _split_entities(text)
    pts, surf_of = _parse_surfaces(ents)
    prod_of_rep, rr_occurrence = _product_graph(ents)

    # representations: ids whose type name ends in SHAPE_REPRESENTATION
    # (plain, ADVANCED_BREP_..., MANIFOLD_SURFACE_..., etc.); surfaces
    # of a rep = B-spline ids reachable through its reference graph
    refs_re = re.compile(r"#(\d+)")
    refs = {eid: [int(x) for x in refs_re.findall(body)]
            for eid, body in ents.items()}

    def rep_surfaces(rid):
        seen, stack, out = {rid}, [rid], []
        while stack:
            e = stack.pop()
            if e in surf_of:
                out.append(e)
            for r in refs.get(e, ()):
                if r not in seen and r in ents:
                    seen.add(r)
                    stack.append(r)
        return out

    # CONTEXT_DEPENDENT_SHAPE_REPRESENTATION is a product-structure
    # record, not a representation — it must not be swept up here (it
    # references the placement relationships, so treating it as a root
    # representation would re-emit every part's masters at identity)
    reps = [eid for eid, body in ents.items()
            if re.match(r"[A-Z0-9_]*SHAPE_REPRESENTATION\s*\(",
                        body.upper())
            and not body.upper().startswith("CONTEXT_DEPENDENT")]

    # relationships: (REPRESENTATION_RELATIONSHIP('','',#child,#parent)
    #   REPRESENTATION_RELATIONSHIP_WITH_TRANSFORMATION(#idt)
    #   SHAPE_REPRESENTATION_RELATIONSHIP())
    links = []  # (parent_rep, child_rep, R, t, occurrence name)
    for eid, body in ents.items():
        up = body.upper()
        if "REPRESENTATION_RELATIONSHIP_WITH_TRANSFORMATION" not in up:
            continue
        if up.startswith("("):
            subs = _split_complex(body)
            rr = subs.get("REPRESENTATION_RELATIONSHIP")
            wt = subs.get(
                "REPRESENTATION_RELATIONSHIP_WITH_TRANSFORMATION")
            if not (rr and wt):
                continue
            rargs = _tokenize(rr)     # (name, desc, rep1, rep2)
            child, parent = _ref(rargs[2]), _ref(rargs[3])
            idt = _ref(_tokenize(wt)[-1])
        else:
            # plain SHAPE_REPRESENTATION_RELATIONSHIP_WITH_
            # TRANSFORMATION(name, desc, rep1, rep2, transformation)
            rargs = _tokenize(body)
            child, parent = _ref(rargs[2]), _ref(rargs[3])
            idt = _ref(rargs[4])
        targs = _tokenize(ents[idt])
        M1, o1 = _axis_frame(_ref(targs[2]), ents, pts)
        M2, o2 = _axis_frame(_ref(targs[3]), ents, pts)
        # the transformation maps frame 1 (child side) onto frame 2
        # (parent side): p' = M2 @ M1^T @ (p - o1) + o2
        R = M2 @ M1.T
        t = o2 - R @ o1
        occ = ""
        if eid in rr_occurrence:
            # product structure is authoritative: NAUO's
            # (parent_pd, child_pd) decides orientation. If the
            # exporter wrote (rep_1=parent, rep_2=child), the
            # transformation maps parent-frame onto child-frame and
            # must be inverted along with the swap.
            prep, crep, occ = rr_occurrence[eid]
            if (parent, child) == (crep, prep):
                parent, child = prep, crep
                R, t = R.T, -(R.T @ t)
            else:
                parent, child = prep, crep
        links.append((parent, child, R, t, occ))

    children = {c for _, c, _, _, _ in links}
    out: list[NURBS] = []
    meta: list[dict] = []
    placed: set[int] = set()

    def place(rid, R, t, path_names, depth=0):
        if depth >= 64:
            raise ValueError("assembly graph cycle")
        pname = prod_of_rep.get(rid)
        for sid in rep_surfaces(rid):
            placed.add(sid)
            out.append(transform_surface(surf_of[sid], R, t))
            meta.append({"product": pname, "path": path_names})
        for parent, child, Rl, tl, occ in links:
            if parent == rid:
                label = occ or prod_of_rep.get(child) or f"rep{child}"
                place(child, R @ Rl, R @ tl + t,
                      path_names + (label,), depth + 1)

    for rid in sorted(reps):
        if rid not in children:
            root_label = prod_of_rep.get(rid) or f"rep{rid}"
            place(rid, np.eye(3), np.zeros(3), (root_label,))
    for sid in sorted(surf_of):
        if sid not in placed and not any(
                sid in rep_surfaces(r) for r in reps):
            out.append(surf_of[sid])
            meta.append({"product": None, "path": ()})
    if not out and surf_of:
        # pathological relationship graph (e.g. an exporter using the
        # opposite rep_1/rep_2 orientation without product records AND
        # circularity filtering dropped everything): never lose
        # geometry — fall back to the un-instanced masters, loudly
        import warnings

        warnings.warn(
            f"{path}: STEP assembly relationships resolved to no "
            "placed geometry; returning un-instanced surfaces at "
            "identity.", stacklevel=2)
        out = [surf_of[k] for k in sorted(surf_of)]
        meta = [{"product": None, "path": ()} for _ in out]
    if with_structure:
        return out, meta
    return out


def write_step_assembly(path: str, parts, instances,
                        name: str = "goldfish_tpu",
                        part_names=None, assembly_name: str = "assembly",
                        instance_names=None):
    """Write an assembly: `parts` is a list of surface lists; each
    instance (part_index, R 3x3, t 3) places one part copy. Emits one
    SHAPE_REPRESENTATION per part, a root assembly representation, and
    one ITEM_DEFINED_TRANSFORMATION +
    (REPRESENTATION_RELATIONSHIP ... WITH_TRANSFORMATION) per instance,
    plus the AP203/AP214 product structure (PRODUCT / PRODUCT_
    DEFINITION / SHAPE_DEFINITION_REPRESENTATION per part and root,
    NEXT_ASSEMBLY_USAGE_OCCURRENCE + CONTEXT_DEPENDENT_SHAPE_
    REPRESENTATION per instance) so CAD tools see a named part tree —
    the metadata OCC resolves for the reference's imports (SURVEY.md
    section 2.4). `part_names` / `assembly_name` / `instance_names`
    name the tree nodes (defaults part{k} / assembly / i{k}).
    Round-trips with `read_step_assembly(with_structure=True)`."""
    part_names = part_names or [f"part{k}" for k in range(len(parts))]
    instance_names = instance_names or [f"i{k}"
                                        for k in range(len(instances))]
    lines = _header_lines(name)
    eid = [1]

    def add(body):
        lines.append(f"#{eid[0]}={body};")
        eid[0] += 1
        return eid[0] - 1

    def add_axis(R=None, t=(0.0, 0.0, 0.0)):
        o = add(f"CARTESIAN_POINT('',({t[0]:.17G},{t[1]:.17G},"
                f"{t[2]:.17G}))")
        if R is None:
            return add(f"AXIS2_PLACEMENT_3D('',#{o},$,$)")
        z, x = np.asarray(R)[:, 2], np.asarray(R)[:, 0]
        dz = add(f"DIRECTION('',({z[0]:.17G},{z[1]:.17G},{z[2]:.17G}))")
        dx = add(f"DIRECTION('',({x[0]:.17G},{x[1]:.17G},{x[2]:.17G}))")
        return add(f"AXIS2_PLACEMENT_3D('',#{o},#{dz},#{dx})")

    ac = add("APPLICATION_CONTEXT('automotive design')")
    pc = add(f"PRODUCT_CONTEXT('',#{ac},'mechanical')")
    pdc = add(f"PRODUCT_DEFINITION_CONTEXT('part definition',#{ac},"
              "'design')")

    def add_product(pname, rep):
        p = add(f"PRODUCT('{pname}','{pname}','',(#{pc}))")
        pdf = add(f"PRODUCT_DEFINITION_FORMATION('','',#{p})")
        pd = add(f"PRODUCT_DEFINITION('design','',#{pdf},#{pdc})")
        pds = add(f"PRODUCT_DEFINITION_SHAPE('','',#{pd})")
        add(f"SHAPE_DEFINITION_REPRESENTATION(#{pds},#{rep})")
        return pd

    part_reps, part_pds = [], []
    for k, surfs in enumerate(parts):
        sids = [_emit_surface(add, s) for s in surfs]
        items = ",".join(f"#{i}" for i in sids)
        rep = add(f"SHAPE_REPRESENTATION('{part_names[k]}',({items}),$)")
        part_reps.append(rep)
        part_pds.append(add_product(part_names[k], rep))
    root = add(f"SHAPE_REPRESENTATION('{assembly_name}',(),$)")
    root_pd = add_product(assembly_name, root)

    for k, (pi, R, t) in enumerate(instances):
        a1 = add_axis()  # identity source frame
        a2 = add_axis(np.asarray(R, dtype=np.float64),
                      np.asarray(t, dtype=np.float64))
        idt = add(f"ITEM_DEFINED_TRANSFORMATION('i{k}','',#{a1},#{a2})")
        rr = add(f"(REPRESENTATION_RELATIONSHIP('','',#{part_reps[pi]},"
                 f"#{root})REPRESENTATION_RELATIONSHIP_WITH_"
                 f"TRANSFORMATION(#{idt})SHAPE_REPRESENTATION_"
                 f"RELATIONSHIP())")
        nauo = add(f"NEXT_ASSEMBLY_USAGE_OCCURRENCE('i{k}',"
                   f"'{instance_names[k]}','',#{root_pd},"
                   f"#{part_pds[pi]},$)")
        pds2 = add(f"PRODUCT_DEFINITION_SHAPE('','',#{nauo})")
        add(f"CONTEXT_DEPENDENT_SHAPE_REPRESENTATION(#{rr},#{pds2})")
    lines += ["ENDSEC;", "END-ISO-10303-21;"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def reparametrize_surfaces(surfs):
    """Normalize every surface's knot vectors to [0, 1] (the role of
    the reference's `reparametrize_BSpline_surfaces`)."""
    out = []
    for s in surfs:
        knots = []
        for k in s.knots:
            k = np.asarray(k, dtype=np.float64)
            knots.append((k - k[0]) / (k[-1] - k[0]))
        out.append(NURBS(knots, s.control.copy()))
    return out


def refine_surfaces(surfs, num_el=(8, 8), degree=3):
    """Elevate + uniformly refine imported surfaces for analysis (the
    role of the reference's `refine_BSpline_surfaces`)."""
    out = []
    for s in surfs:
        p0, q0 = s.degree
        r = s.elevate(0, max(degree - p0, 0)).elevate(
            1, max(degree - q0, 0))
        for ax in range(2):
            existing = np.unique(r.knots[ax])
            want = np.linspace(0.0, 1.0, num_el[ax] + 1)
            add = np.array([k for k in want
                            if np.min(np.abs(existing - k)) > 1e-12])
            if add.size:
                r = r.refine(ax, add)
        out.append(r)
    return out
