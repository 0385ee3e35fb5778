"""The port's CIF parser (``cgnn_tpu_torch/data/cif.py``) against the JAX
package's on the same text: each hostile-corpus fixture under
``tests/fixtures/cif/`` gives a bit-equal Structure (atomic numbers,
fractional coordinates, lattice) on both stacks, or both refuse it with
their own ``CIFError``; the symmetry-operator parser agrees on operator
strings; ``write_cif_file`` output of either stack parses on the other
to the same bits."""

import os

import numpy as np
import pytest

from cgnn_tpu.data import cif as jcif
from cgnn_tpu.data import synthetic as jsynthetic
from cgnn_tpu.data.structure import Structure as JStructure
from cgnn_tpu_torch.data import cif as tcif
from cgnn_tpu_torch.data.structure import Structure
from test_torch_train import jax_search_on_numpy  # noqa: F401 — autouse

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "cif")
CORPUS = sorted(os.listdir(FIXTURES))


def _assert_same_structure(got, want):
    np.testing.assert_array_equal(got.numbers, want.numbers)
    assert got.numbers.dtype == want.numbers.dtype
    np.testing.assert_array_equal(got.frac_coords, want.frac_coords)
    np.testing.assert_array_equal(got.lattice, want.lattice)


def test_corpus_is_the_eighteen_fixtures():
    assert len(CORPUS) == 18 and all(n.endswith(".cif") for n in CORPUS)


@pytest.mark.parametrize("name", CORPUS)
def test_fixture_parses_like_the_jax_parser(name):
    path = os.path.join(FIXTURES, name)
    try:
        want = jcif.parse_cif_file(path)
    except jcif.CIFError as e:
        with pytest.raises(tcif.CIFError) as got:
            tcif.parse_cif_file(path)
        assert str(got.value) == str(e)
        return
    got = tcif.parse_cif_file(path)
    assert isinstance(got, Structure)
    _assert_same_structure(got, want)


SYMOPS = ["x,y,z", "-x,-y,-z", "1/2+x, 1/2-y, z", "x-y,x,z+1/6",
          "-y+0.25,x+3/4,-z", "Z, X, Y", "x+1/3,y+2/3,z+2/3", "-x+y,y,-z+1/2"]


@pytest.mark.parametrize("op", SYMOPS)
def test_symmetry_op_parses_like_the_jax_parser(op):
    (rot, trans), (jrot, jtrans) = (tcif.parse_symmetry_op(op),
                                    jcif.parse_symmetry_op(op))
    np.testing.assert_array_equal(rot, jrot)
    np.testing.assert_array_equal(trans, jtrans)


@pytest.mark.parametrize("op", ["x,y", "x,y,q", "x,,z"])
def test_bad_symmetry_op_is_refused_on_both_stacks(op):
    with pytest.raises(jcif.CIFError):
        jcif.parse_symmetry_op(op)
    with pytest.raises(tcif.CIFError):
        tcif.parse_symmetry_op(op)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_write_cif_round_trip_across_stacks(writer, tmp_path):
    """Each stack's CIF text equals the other's, and parses on both to
    the same bits."""
    cells = [s for _, s, _ in jsynthetic.synthetic_dataset(4, seed=7,
                                                           max_atoms=6)]
    cells += [s for _, s, _ in jsynthetic.synthetic_mp_dataset(2, seed=3)]
    for i, js in enumerate(cells):
        ts = Structure(js.lattice, js.frac_coords, js.numbers)
        assert tcif.structure_to_cif(ts, f"c{i}") == jcif.structure_to_cif(
            js, f"c{i}")
        path = str(tmp_path / f"c{i}.cif")
        if writer == "port":
            tcif.write_cif_file(ts, path, name=f"c{i}")
        else:
            jcif.write_cif_file(js, path, name=f"c{i}")
        got, want = tcif.parse_cif_file(path), jcif.parse_cif_file(path)
        _assert_same_structure(got, want)
        # the written cell is the cell, to the text's six decimals
        assert len(got.numbers) == len(js.numbers)
        np.testing.assert_allclose(got.lattice, js.lattice, atol=2e-5)
        assert isinstance(want, JStructure)
