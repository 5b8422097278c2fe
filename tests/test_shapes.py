import pytest

from tensor_ops.ops.shapes import (
    ShapeError,
    as_shape,
    as_stack,
    check_prefix,
    check_stack_eq,
)


def test_as_shape():
    assert as_shape(3) == (3,)
    assert as_shape(()) == ()
    assert as_shape([2, 3]) == (2, 3)


def test_as_shape_rejects_bad_dims():
    with pytest.raises(ShapeError):
        as_shape([-1])
    with pytest.raises(ShapeError):
        as_shape([2.5])


def test_as_stack():
    assert as_stack([(), 3, (2, 3)]) == ((), (3,), (2, 3))


def test_check_stack_eq():
    check_stack_eq("t", ((2,),), ((2,),))
    with pytest.raises(ShapeError):
        check_stack_eq("t", ((2,),), ((3,),))


def test_check_prefix():
    assert check_prefix("t", ((2,), (3,), (4,)), ((2,),)) == ((3,), (4,))
    with pytest.raises(ShapeError):
        check_prefix("t", ((2,), (3,)), ((9,),))
