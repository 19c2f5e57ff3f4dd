"""Device programs split into segments at their host decisions.

The reference's programs keep their stage decisions on the device
(``lax.cond``), so each is one executable. Here the three stage decisions
are host branches (ops/deblock.py, ops/deblur.py), so a program is a chain
of segments: the host reads one flag between two of them and picks the
branch of the next. Both branches of a decision return the same named
tensors, so every segment after it is shared by both.

A program is written as a list of ``Piece``s, each a function of the named
tensors computed so far (the ``state``) returning new or replaced ones; a
piece with a ``decision`` starts a segment, and runs its ``run`` when the
host flag ``any.<decision>`` of the state is set, its ``skip`` otherwise.
``Program`` runs the segments eagerly in turn; the engine's executable tier
(serve/exec_cache.py) captures each segment and branch as a CUDA graph and
replays them, reading the same flags between them.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import torch

from ...obs.metrics import host_flag


@dataclass(frozen=True)
class Piece:
    """``run(state) -> {name: tensor}``; with a ``decision``, ``skip`` is the
    branch taken when the host flag is not set, returning the same names."""

    run: Callable[[dict], dict]
    decision: str | None = None
    skip: Callable[[dict], dict] | None = None


@dataclass(frozen=True)
class Segment:
    """Pieces run together: the first may hold the host decision before
    them, the others have none."""

    pieces: tuple[Piece, ...]

    @property
    def decision(self) -> str | None:
        return self.pieces[0].decision

    @property
    def branches(self) -> tuple[bool, ...]:
        """The branches to capture: both sides of a decision, else one."""
        return (True, False) if self.decision else (True,)

    def run(self, state: dict, taken: bool = True) -> dict:
        """The names this segment computes from ``state``, on the branch
        ``taken`` of its decision."""
        updates: dict = {}
        for i, piece in enumerate(self.pieces):
            fn = piece.run if (taken or i > 0) else piece.skip
            updates.update(fn({**state, **updates}))
        return updates


def segments_of(pieces: list[Piece]) -> tuple[Segment, ...]:
    """The pieces grouped into segments, a new one at each decision."""
    groups: list[list[Piece]] = []
    for piece in pieces:
        if piece.decision is not None and piece.skip is None:
            raise ValueError(f"decision {piece.decision!r} has no skip branch")
        if not groups or piece.decision is not None:
            groups.append([])
        groups[-1].append(piece)
    return tuple(Segment(tuple(g)) for g in groups)


def decide(segment: Segment, state: dict) -> bool:
    """The branch of ``segment`` to take: its host flag, read as a counted
    and timed synchronisation (``obs.metrics.host_flag``), or True."""
    if segment.decision is None:
        return True
    return host_flag(segment.decision, state[f"any.{segment.decision}"])


def run_segments(segments: tuple[Segment, ...], state: dict) -> dict:
    """Every segment in turn, each on the branch its decision picks."""
    for segment in segments:
        state = {**state, **segment.run(state, decide(segment, state))}
    return state


class Program:
    """A device program over named inputs, as segments.

    ``pieces(model, shapes)`` lists the pieces for inputs of those shapes
    (a stage that does not apply at a size has none); ``outputs`` names the
    tensors the program returns, flat, and ``result`` shapes that tuple into
    the program's return value. Calling the program runs it eagerly; a
    ``fires`` dict receives the stages' ``fires.<name>`` masks."""

    def __init__(self, inputs: tuple[str, ...], pieces: Callable, outputs: tuple[str, ...],
                 result: Callable[[tuple], object] | None = None):
        self.inputs = inputs
        self.pieces = pieces
        self.outputs = outputs
        self.result = result or (lambda outs: outs[0] if len(outs) == 1 else outs)

    def segments(self, model, args) -> tuple[Segment, ...]:
        return segments_of(self.pieces(model, tuple(tuple(a.shape) for a in args)))

    def run(self, model, args) -> tuple[dict, tuple[torch.Tensor, ...]]:
        """(final state, flat outputs) of an eager run on device tensors."""
        if len(args) != len(self.inputs):
            raise TypeError(f"the program takes {self.inputs}, got {len(args)} arguments")
        with torch.inference_mode():
            state = run_segments(self.segments(model, args), dict(zip(self.inputs, args)))
        return state, tuple(state[name] for name in self.outputs)

    def __call__(self, model, *args, fires: dict | None = None):
        state, outs = self.run(model, args)
        if fires is not None:
            fires.update({k.split(".", 1)[1]: v for k, v in state.items() if k.startswith("fires.")})
        return self.result(outs)
