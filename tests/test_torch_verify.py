"""The port's differential exerciser (`repro_torch.verify`) against the
reference's (`repro.verify`), on the cases of `tests/test_verify.py`.

The generators draw from `np.random.default_rng` exactly as the
reference's do, so the same seed must give the same program, row for
row, in both packages; and every family of the CLI's rotation (the five
engine families, collective, racy, vm and serve) must give the same
verdict for each of seeds 0-31.  The mutation checks plant their bug in
the port's back-end (`repro_torch.core.backend._exec_copy_group`) and
never in the reference's.
"""

import dataclasses
import enum

import pytest

import repro.verify as JV
import repro.verify.__main__ as JM
import repro_torch.core.backend as backend
import repro_torch.verify as TV
import repro_torch.verify.__main__ as TM
from repro_torch.verify import (FAMILIES, check_program, generate_program,
                                shrink_program)
from repro_torch.verify.__main__ import run_seeds
from repro_torch.verify.serve import (check_serve_program,
                                      generate_serve_program,
                                      shrink_serve_program)


def text(s):
    return s.replace("repro_torch", "repro")


def verdict(d):
    """A divergence (or None) as text, equal across the two packages."""
    return None if d is None else text(str(d))


def plain(obj):
    """A value of plain Python types, equal across the two packages."""
    if isinstance(obj, enum.Enum):
        return obj.name
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return tuple(plain(getattr(obj, f.name))
                     for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


def program_snap(program):
    """A program's text, every submission's kind, rows, options and N-d
    transfer, its memory seed and its fault sites."""
    return (program.describe(),
            [(sub.kind, plain(sub.rows), plain(sub.options), plain(sub.nd))
             for sub in program.submissions],
            program.mem_seed, plain(program.fault_sites))


class TestGenerator:
    def test_same_seed_same_program(self):
        for seed in (0, 7, 23):
            a = generate_program(seed)
            b = generate_program(seed)
            assert a.describe() == b.describe()
            assert a.fault_sites == b.fault_sites
            assert a.mem_seed == b.mem_seed
            assert a.spec == b.spec
            assert program_snap(a) == program_snap(JV.generate_program(seed))

    def test_family_pinning_and_rotation(self):
        assert generate_program(3, family="cheshire").family == "cheshire"
        assert {generate_program(s).family for s in range(5)} \
            == set(FAMILIES)
        assert FAMILIES == JV.FAMILIES
        assert TM.ALL_FAMILIES == JM.ALL_FAMILIES

    def test_programs_are_materializable(self):
        for seed in range(8):
            prog = generate_program(seed)
            assert prog.num_rows >= 1
            for sub in prog.submissions:
                assert sub.materialize() is not None

    @pytest.mark.parametrize("seed", range(32))
    def test_programs_equal_the_reference(self, seed):
        assert program_snap(TV.generate_program(seed)) == \
            program_snap(JV.generate_program(seed))
        (tp, tcode), (jp, jcode) = (TV.generate_racy_program(seed),
                                    JV.generate_racy_program(seed))
        assert tcode == jcode
        assert program_snap(tp) == program_snap(jp)


def _family_run(M, family, seed):
    program, d, _ = M._run_one(seed, family)
    return program.describe(), program.num_rows, verdict(d)


@pytest.mark.parametrize("family", JM.ALL_FAMILIES)
def test_family_verdicts_equal_the_reference(family):
    for seed in range(32):
        got = _family_run(TM, family, seed)
        assert got == _family_run(JM, family, seed), (family, seed)
        assert got[2] is None, (family, seed, got[2])


def test_differential_rotation_equals_the_reference():
    runs = [M.run_seeds(range(32), log=lambda *a: None, differential=True)
            for M in (JM, TM)]
    (jt, jd), (tt, td) = runs
    assert td == [] and tt == jt
    assert [verdict(d) for d in td] == [verdict(d) for d in jd]


class TestDifferential:
    def test_seeds_across_all_families_pass(self):
        totals, divergences = run_seeds(range(10), log=lambda *a: None)
        assert divergences == []
        assert totals["programs"] == 10
        assert totals["rows"] >= 10
        assert totals == JM.run_seeds(range(10), log=lambda *a: None)[0]


def _corrupt_port_backend(monkeypatch):
    """Corrupt one destination byte per grouped copy in the port's batch
    path; the scalar oracle moves bytes through Read/WriteManager and
    never calls `_exec_copy_group`."""
    orig = backend._exec_copy_group

    def corrupt(src_buf, dst_buf, sa, da, lens, instream, bins=None):
        orig(src_buf, dst_buf, sa, da, lens, instream, bins)
        if len(da):
            dst_buf[int(da[0])] ^= 0xFF

    monkeypatch.setattr(backend, "_exec_copy_group", corrupt)


class TestMutationCheck:
    @pytest.fixture
    def planted_bug(self, monkeypatch):
        _corrupt_port_backend(monkeypatch)

    def test_planted_bug_is_caught(self, planted_bug):
        d = check_program(generate_program(1))
        assert d is not None
        assert d.kind == "bytes"
        assert "engine-vs-oracle" in d.detail
        assert JV.check_program(JV.generate_program(1)) is None

    def test_planted_bug_shrinks_to_minimal_repro(self, planted_bug):
        prog = generate_program(1)
        d = check_program(prog)
        small, small_d = shrink_program(prog, d)
        assert small_d is not None and small_d.kind == d.kind
        assert len(small.submissions) == 1
        assert small.num_rows < prog.num_rows
        assert small.num_rows <= 2
        assert not small.fault_sites
        assert check_program(small).kind == d.kind

    def test_clean_run_after_unpatch(self):
        assert check_program(generate_program(1)) is None


class TestServeFamily:
    def test_same_seed_same_program(self):
        from repro.verify.serve import generate_serve_program as j_gen
        for seed in (0, 8, 17):
            a = generate_serve_program(seed)
            assert a.describe() == generate_serve_program(seed).describe()
            assert a.describe() == j_gen(seed).describe()

    def test_clean_seeds_pass(self):
        for seed in range(4):
            assert check_serve_program(generate_serve_program(seed)) \
                is None

    def test_planted_bug_caught_and_shrunk(self, monkeypatch):
        _corrupt_port_backend(monkeypatch)
        prog = generate_serve_program(0)
        d = check_serve_program(prog)
        assert d is not None and d.kind == "serve-tokens"
        small, small_d = shrink_serve_program(prog, d, budget=40)
        assert small_d.kind == d.kind
        assert len(small.requests) <= len(prog.requests)
        assert small.num_rows <= prog.num_rows


def test_cli_main_equals_the_reference(capsys):
    """``main`` prints the same summary line and returns 0 in both
    packages, for the oracle rotation and for ``--differential``."""
    for argv in (["--seeds", "9"], ["--seeds", "6", "--differential"]):
        assert JM.main(argv) == 0
        want = capsys.readouterr().out
        assert TM.main(argv) == 0
        assert capsys.readouterr().out == want
