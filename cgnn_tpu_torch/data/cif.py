"""In-tree CIF parser (``cgnn_tpu/data/cif.py``, a numpy copy: the port
imports nothing of the JAX package).

Supports the subset the pipeline needs: cell parameters, atom-site loops
(type symbol or label), fractional coordinates, mmCIF-style dotted tags
(folded to underscores), and symmetry expansion via
``_symmetry_equiv_pos_as_xyz`` / ``_space_group_symop_operation_xyz`` loops
(affine x,y,z expression strings applied and deduplicated). There is no
space-group-symbol engine: files declaring a non-P1 Hermann-Mauguin symbol
or IT number WITHOUT an explicit operator loop are REFUSED loudly (reading
only the asymmetric unit as P1 would silently drop atoms). Hostile-corpus
fixtures: tests/fixtures/cif/.

Out of scope (errors loudly): partial occupancies < 1, disordered sites.
"""

from __future__ import annotations

import re
import shlex

import numpy as np

from cgnn_tpu_torch.data.elements import SYMBOL_TO_Z, Z_TO_SYMBOL
from cgnn_tpu_torch.data.structure import Structure, lattice_from_parameters


class CIFError(ValueError):
    """The text is not a CIF this parser can turn into a P1 Structure."""


def _strip_comment(line: str) -> str:
    # '#' starts a comment unless inside quotes; cheap scan.
    out, in_q = [], None
    for ch in line:
        if in_q:
            out.append(ch)
            if ch == in_q:
                in_q = None
        elif ch in "'\"":
            in_q = ch
            out.append(ch)
        elif ch == "#":
            break
        else:
            out.append(ch)
    return "".join(out)


def _tokenize(text: str) -> list[str]:
    """CIF token stream: handles quotes, semicolon text fields, comments."""
    tokens: list[str] = []
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith(";"):  # multi-line text field
            field = [line[1:]]
            i += 1
            while i < len(lines) and not lines[i].startswith(";"):
                field.append(lines[i])
                i += 1
            tokens.append("\n".join(field))
            i += 1
            continue
        line = _strip_comment(line).strip()
        if line:
            try:
                lexer = shlex.shlex(line, posix=True)
                lexer.whitespace_split = True
                lexer.quotes = "'\""
                lexer.commenters = ""
                tokens.extend(list(lexer))
            except ValueError as e:
                raise CIFError(f"unparseable CIF line {i + 1}: {line!r}") from e
        i += 1
    return tokens


_NUM_RE = re.compile(
    r"^([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)(?:\(\d+\))?$"
)


def _parse_number(tok: str) -> float:
    """CIF numeric value, stripping the '(esd)' suffix, e.g. '4.0521(3)'."""
    m = _NUM_RE.match(tok)
    if not m:
        raise CIFError(f"expected a number, got {tok!r}")
    return float(m.group(1))


_SYMBOL_RE = re.compile(r"^([A-Za-z]{1,2})")


def _symbol_from_label(label: str) -> str:
    """'Fe2+', 'O1', 'FE1', 'Ca_a' -> element symbol.

    Case-insensitive: all-caps labels ('FE1', 'CA2') are common in legacy
    CIFs. The two-letter reading is preferred when it is a valid element
    ('FE'->Fe, not F), matching pymatgen's resolution of the ambiguity.
    """
    m = _SYMBOL_RE.match(label.strip())
    if not m:
        raise CIFError(f"cannot extract element symbol from {label!r}")
    raw = m.group(1)
    two = raw.capitalize() if len(raw) == 2 else None
    one = raw[0].upper()
    if two and two in SYMBOL_TO_Z:
        return two
    if one in SYMBOL_TO_Z:
        return one
    raise CIFError(f"unknown element in site label {label!r}")


def _norm_tag(tag: str) -> str:
    """Lowercase a data name and fold mmCIF's category.item dots to
    underscores: '_atom_site.fract_x' -> '_atom_site_fract_x'."""
    return tag.lower().replace(".", "_")


def _parse_blocks(tokens: list[str]) -> list[dict]:
    """All data_ blocks -> [{"items": {tag: value}, "loops": [...]}, ...].

    Selection policy lives in ``parse_cif``: the first block carrying an
    atom-site loop with fractional coordinates wins (publication CIFs often
    lead with a metadata-only block); with no such block, the first block
    is used so its specific failure (Cartesian-only sites, no sites) is
    reported.
    """
    blocks: list[dict] = []
    items: dict[str, str] = {}
    loops: list[tuple[list[str], list[list[str]]]] = []
    i = 0
    n = len(tokens)
    seen_data = False
    while i < n:
        tok = tokens[i]
        low = tok.lower()
        if low.startswith("data_"):
            if seen_data:
                blocks.append({"items": items, "loops": loops})
                items, loops = {}, []
            seen_data = True
            i += 1
        elif low == "loop_":
            i += 1
            headers = []
            while i < n and tokens[i].startswith("_"):
                headers.append(_norm_tag(tokens[i]))
                i += 1
            values = []
            while i < n and not tokens[i].startswith("_") and \
                    not tokens[i].lower().startswith(("loop_", "data_")):
                values.append(tokens[i])
                i += 1
            if headers and len(values) % len(headers) == 0:
                rows = [
                    values[j : j + len(headers)]
                    for j in range(0, len(values), len(headers))
                ]
                loops.append((headers, rows))
            elif headers:
                raise CIFError(
                    f"loop with {len(headers)} columns has {len(values)} values"
                )
        elif tok.startswith("_"):
            if i + 1 < n and not tokens[i + 1].startswith("_") and \
                    not tokens[i + 1].lower().startswith(("loop_", "data_")):
                items[_norm_tag(tok)] = tokens[i + 1]
                i += 2
            else:
                items[_norm_tag(tok)] = ""
                i += 1
        else:
            i += 1
    blocks.append({"items": items, "loops": loops})
    return blocks


def _has_fract_sites(block: dict) -> bool:
    return any(
        h.startswith("_atom_site_fract")
        for headers, _ in block["loops"]
        for h in headers
    )


_FRAC_RE = re.compile(r"(\d+)\s*/\s*(\d+)")


def parse_symmetry_op(op: str) -> tuple[np.ndarray, np.ndarray]:
    """'x,y,z'-style affine operator string -> (rotation [3,3], translation [3]).

    Handles terms like '-x', '1/2+y', 'x-y', '0.25+z'. Implemented as a hand
    parser (no eval) over '+'/'-'-separated terms.
    """
    rot = np.zeros((3, 3), dtype=np.float64)
    trans = np.zeros(3, dtype=np.float64)
    parts = op.lower().replace(" ", "").split(",")
    if len(parts) != 3:
        raise CIFError(f"bad symmetry op {op!r}")
    axis = {"x": 0, "y": 1, "z": 2}
    for row, expr in enumerate(parts):
        # split into signed terms
        terms = re.findall(r"[+-]?[^+-]+", expr)
        if not terms:
            raise CIFError(f"bad symmetry expression {expr!r} in {op!r}")
        for term in terms:
            sign = -1.0 if term.startswith("-") else 1.0
            body = term.lstrip("+-")
            if body in axis:
                rot[row, axis[body]] += sign
            else:
                m = _FRAC_RE.fullmatch(body)
                if m:
                    trans[row] += sign * int(m.group(1)) / int(m.group(2))
                else:
                    try:
                        trans[row] += sign * float(body)
                    except ValueError as e:
                        raise CIFError(
                            f"bad symmetry term {term!r} in {op!r}"
                        ) from e
    return rot, trans


_SYMOP_TAGS = (
    "_symmetry_equiv_pos_as_xyz",
    "_space_group_symop_operation_xyz",
)


def parse_cif(text: str, occupancy_tol: float = 0.999) -> Structure:
    """CIF text -> Structure (symmetry-expanded to the full cell, P1).

    Multi-block files: the FIRST block with fractional atom sites is the
    structure (see _parse_blocks for the policy rationale).
    """
    blocks = _parse_blocks(_tokenize(text))
    parsed = next((b for b in blocks if _has_fract_sites(b)), blocks[0])
    items, loops = parsed["items"], parsed["loops"]

    try:
        cell = [
            _parse_number(items[k])
            for k in (
                "_cell_length_a",
                "_cell_length_b",
                "_cell_length_c",
                "_cell_angle_alpha",
                "_cell_angle_beta",
                "_cell_angle_gamma",
            )
        ]
    except KeyError as e:
        raise CIFError(f"missing cell parameter {e}") from e
    lattice = lattice_from_parameters(*cell)

    # Atom-site loop.
    site_loop = None
    for headers, rows in loops:
        if any(h.startswith("_atom_site_fract") for h in headers):
            site_loop = (headers, rows)
            break
    if site_loop is None:
        if any(
            h.startswith("_atom_site_cartn")
            for headers, _ in loops for h in headers
        ):
            raise CIFError(
                "atom sites give only Cartesian (_atom_site_Cartn_*) "
                "coordinates (mmCIF convention); fractional coordinates "
                "are required"
            )
        raise CIFError("no _atom_site_ loop with fractional coordinates")
    headers, rows = site_loop

    def col(name: str) -> int | None:
        return headers.index(name) if name in headers else None

    ix = col("_atom_site_fract_x")
    iy = col("_atom_site_fract_y")
    iz = col("_atom_site_fract_z")
    if None in (ix, iy, iz):
        raise CIFError("atom-site loop lacks fract_x/y/z")
    isym = col("_atom_site_type_symbol")
    ilab = col("_atom_site_label")
    iocc = col("_atom_site_occupancy")
    if isym is None and ilab is None:
        raise CIFError("atom-site loop lacks both type_symbol and label")

    symbols, fracs = [], []
    for row in rows:
        if iocc is not None and row[iocc] not in (".", "?"):
            occ = _parse_number(row[iocc])
            if occ < occupancy_tol:
                raise CIFError(
                    f"partial occupancy {occ} unsupported (site {row})"
                )
        raw = row[isym] if isym is not None else row[ilab]
        symbols.append(_symbol_from_label(raw))
        fracs.append([_parse_number(row[i]) for i in (ix, iy, iz)])

    # Symmetry operators (default: identity only == P1).
    ops: list[tuple[np.ndarray, np.ndarray]] = []
    for headers2, rows2 in loops:
        for tag in _SYMOP_TAGS:
            if tag in headers2:
                j = headers2.index(tag)
                ops = [parse_symmetry_op(r[j]) for r in rows2]
                break
        if ops:
            break
    for tag in _SYMOP_TAGS:  # non-loop single op
        if not ops and tag in items and items[tag]:
            ops = [parse_symmetry_op(items[tag])]
    if not ops:
        # No explicit operators: refuse files that DECLARE a non-P1 space
        # group by Hermann-Mauguin symbol or IT number — silently reading
        # them as P1 would drop all but the asymmetric unit's atoms (error
        # loudly: there is no Hermann-Mauguin engine).
        hm = next(
            (
                items[t]
                for t in (
                    "_symmetry_space_group_name_h-m",
                    "_space_group_name_h-m_alt",
                )
                if items.get(t)
            ),
            "",
        )
        it_number = items.get(
            "_space_group_it_number",
            items.get("_symmetry_int_tables_number", ""),
        )
        hm_flat = hm.replace(" ", "").replace("_", "").upper()
        # '.'/'?' are CIF placeholders for inapplicable/unknown, not a
        # declared space group — fall through to the IT-number check
        hm_declared = hm and hm_flat not in (".", "?")
        if hm_declared and hm_flat != "P1":
            raise CIFError(
                f"space group {hm!r} declared without an explicit symmetry-"
                f"operator loop ({'/'.join(_SYMOP_TAGS)}); this parser has "
                f"no Hermann-Mauguin engine — re-export the file with "
                f"explicit operators or symmetry-expanded (P1) sites"
            )
        # checked regardless of a (possibly mislabeled) 'P 1' H-M value: a
        # declared non-1 IT number with no operators means the sites are an
        # asymmetric unit either way
        if it_number and it_number not in ("1", ".", "?"):
            raise CIFError(
                f"space group IT number {it_number} declared without an "
                f"explicit symmetry-operator loop; cannot expand (no "
                f"space-group table in this parser)"
            )
        # Hall symbols declare a group just as firmly as H-M/IT-number do:
        # a Hall-only non-P1 CIF parsed as P1 would drop the
        # symmetry-equivalent atoms. P1's Hall symbol is 'P 1'.
        hall = next(
            (
                items[t]
                for t in (
                    "_space_group_name_hall",
                    "_symmetry_space_group_name_hall",
                )
                if items.get(t)
            ),
            "",
        )
        hall_flat = hall.replace(" ", "").replace("_", "").upper()
        if hall and hall_flat not in ("P1", ".", "?"):
            raise CIFError(
                f"Hall symbol {hall!r} declared without an explicit "
                f"symmetry-operator loop; this parser has no Hall engine — "
                f"re-export with explicit operators or P1 sites"
            )
        ops = [(np.eye(3), np.zeros(3))]

    # Expand and deduplicate (wrap to [0,1), merge within tolerance).
    out_fracs: list[np.ndarray] = []
    out_numbers: list[int] = []
    tol = 1e-3
    for sym, frac in zip(symbols, fracs):
        z = SYMBOL_TO_Z[sym]
        base = np.asarray(frac, dtype=np.float64)
        for rot, trans in ops:
            pos = (rot @ base + trans) % 1.0
            dup = False
            for existing in out_fracs:
                delta = np.abs(pos - existing)
                delta = np.minimum(delta, 1.0 - delta)  # periodic distance
                if np.all(delta < tol):
                    dup = True
                    break
            if not dup:
                out_fracs.append(pos)
                out_numbers.append(z)

    return Structure(lattice, np.array(out_fracs), np.array(out_numbers))


def parse_cif_file(path) -> Structure:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_cif(f.read())


def structure_to_cif(structure: Structure, name: str = "structure") -> str:
    """Minimal P1 CIF text for a Structure (round-trips through parse_cif).

    Inverse of the parser for the subset the pipeline needs: P1 cells with
    explicit sites (symmetry-expanded output, no symmetry operations).
    """
    a, b, c, alpha, beta, gamma = structure.lattice_parameters()
    lines = [
        f"data_{name}",
        f"_cell_length_a {a:.6f}",
        f"_cell_length_b {b:.6f}",
        f"_cell_length_c {c:.6f}",
        f"_cell_angle_alpha {alpha:.6f}",
        f"_cell_angle_beta {beta:.6f}",
        f"_cell_angle_gamma {gamma:.6f}",
        "loop_",
        "_atom_site_label",
        "_atom_site_type_symbol",
        "_atom_site_fract_x",
        "_atom_site_fract_y",
        "_atom_site_fract_z",
    ]
    fracs = structure.wrapped().frac_coords
    for i, (z, f) in enumerate(zip(structure.numbers, fracs)):
        sym = Z_TO_SYMBOL[int(z)]
        lines.append(
            f"{sym}{i + 1} {sym} {f[0]:.6f} {f[1]:.6f} {f[2]:.6f}"
        )
    return "\n".join(lines) + "\n"


def write_cif_file(structure: Structure, path, name: str = "structure") -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(structure_to_cif(structure, name))
