"""The port's model configurations as the reference holds them."""

import dataclasses


def is_reference_data(ours, theirs) -> None:
    """Assert ``ours`` holds every field of ``theirs`` at its value
    (nested parts alike) and every field the port adds (``first_dense``,
    ``norm_topk``, ``rope_scaling``) at its default."""
    if not dataclasses.is_dataclass(theirs):
        assert ours == theirs
        return
    assert dataclasses.is_dataclass(ours), (ours, theirs)
    names = {f.name for f in dataclasses.fields(theirs)}
    assert names <= {f.name for f in dataclasses.fields(ours)}
    for f in dataclasses.fields(ours):
        if f.name in names:
            is_reference_data(getattr(ours, f.name), getattr(theirs, f.name))
        else:
            assert getattr(ours, f.name) == f.default, (type(ours), f.name)
