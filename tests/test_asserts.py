"""Expression-decomposing assertion engine (≙ assertions.hpp:204-292)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ddp_jax.diagnostics.asserts import ddp_assert, ddp_assert_any_of, ddp_expect, val


def test_all_of_passes_silently(capsys):
    ddp_assert(val(3) > 2, val("a") == "a", msg="fine")
    assert capsys.readouterr().out == ""


def test_failure_reports_every_conjunct_with_values():
    mu = 0.5
    T = 10
    with pytest.raises(AssertionError) as exc:
        ddp_assert(
            val(mu, "mu") > 1.0,
            val(T, "T") == 10,
            val(2 * T) < T,
            msg="solver preconditions",
        )
    text = str(exc.value)
    # the failing conjuncts show operator and both operand values
    assert "[FAILED] mu = 0.5 > 1.0" in text
    assert "[passed] T = 10 == 10" in text
    assert "[FAILED] 20 < 10" in text
    assert "solver preconditions" in text
    # caller location is captured
    assert "test_asserts.py" in text


def test_any_of_semantics():
    ddp_assert_any_of(val(1) > 2, val(3) > 2)  # one holds → ok
    with pytest.raises(AssertionError) as exc:
        ddp_assert_any_of(val(1) > 2, val(1) > 3, msg="no branch")
    assert str(exc.value).count("[FAILED]") == 2


def test_expect_is_nonfatal(capsys):
    assert ddp_expect(val(1) == 1) is True
    assert ddp_expect(val(1) == 2, msg="soft") is False
    out = capsys.readouterr().out
    assert "expectation" in out and "1 == 2" in out


def test_array_conditions_reduce_with_all():
    x = jnp.asarray([1.0, 2.0, 3.0])
    ddp_assert(val(x) > 0.0)  # all positive → passes
    with pytest.raises(AssertionError):
        ddp_assert(val(x) > 1.5, msg="not all above")
    assert ddp_expect(val(np.asarray([True, True]))) is True


def test_plain_bool_conditions_still_work():
    ddp_assert(True, 1 == 1)
    with pytest.raises(AssertionError):
        ddp_assert(True, False, msg="bare bool")
