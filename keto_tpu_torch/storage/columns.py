"""Columnar relation tuples: seven parallel numpy arrays in place of one
Python object a tuple, the form the columnar store keeps and the
columnar mirror builders read (engine/snapshot.build_snapshot_columnar).

Layout (every array has one length):
  ns, obj, rel          unicode arrays: the tuple's own coordinates
  skind                 int8, 0 = a plain subject id, 1 = a subject set
  sns, sobj, srel       the subject's columns; a plain subject keeps its
                        id in sobj and "" in sns and srel

The same layout as the JAX package's (keto_tpu/storage/columns.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence

import numpy as np

from ..ketoapi import RelationTuple, SubjectSet

FIELDS = ("ns", "obj", "rel", "skind", "sns", "sobj", "srel")


@dataclass
class TupleColumns:
    ns: np.ndarray
    obj: np.ndarray
    rel: np.ndarray
    skind: np.ndarray
    sns: np.ndarray
    sobj: np.ndarray
    srel: np.ndarray

    def __len__(self) -> int:
        return len(self.ns)

    def nbytes(self) -> int:
        return sum(getattr(self, f).nbytes for f in FIELDS)

    @classmethod
    def empty(cls) -> "TupleColumns":
        u = np.array([], dtype="U1")
        return cls(ns=u.copy(), obj=u.copy(), rel=u.copy(),
                   skind=np.array([], dtype=np.int8),
                   sns=u.copy(), sobj=u.copy(), srel=u.copy())

    @classmethod
    def from_tuples(cls, tuples: Sequence[RelationTuple]) -> "TupleColumns":
        n = len(tuples)
        ns, obj, rel = [""] * n, [""] * n, [""] * n
        sns, sobj, srel = [""] * n, [""] * n, [""] * n
        skind = np.zeros(n, dtype=np.int8)
        for i, t in enumerate(tuples):
            ns[i], obj[i], rel[i] = t.namespace, t.object, t.relation
            if t.subject_set is not None:
                s = t.subject_set
                skind[i] = 1
                sns[i], sobj[i], srel[i] = s.namespace, s.object, s.relation
            else:
                sobj[i] = t.subject_id or ""
        return cls(
            ns=np.asarray(ns, dtype="U"), obj=np.asarray(obj, dtype="U"),
            rel=np.asarray(rel, dtype="U"), skind=skind,
            sns=np.asarray(sns, dtype="U"), sobj=np.asarray(sobj, dtype="U"),
            srel=np.asarray(srel, dtype="U"),
        )

    def row(self, i: int) -> RelationTuple:
        if self.skind[i]:
            return RelationTuple(
                namespace=str(self.ns[i]), object=str(self.obj[i]), relation=str(self.rel[i]),
                subject_set=SubjectSet(namespace=str(self.sns[i]), object=str(self.sobj[i]),
                                       relation=str(self.srel[i])),
            )
        return RelationTuple(namespace=str(self.ns[i]), object=str(self.obj[i]),
                             relation=str(self.rel[i]), subject_id=str(self.sobj[i]))

    def iter_tuples(self) -> Iterator[RelationTuple]:
        for i in range(len(self)):
            yield self.row(i)

    def take(self, idx: np.ndarray) -> "TupleColumns":
        return TupleColumns(*(getattr(self, f)[idx] for f in FIELDS))


def concat_columns(parts: Iterable[TupleColumns]) -> TupleColumns:
    parts = [p for p in parts if len(p)]
    if not parts:
        return TupleColumns.empty()
    if len(parts) == 1:
        return parts[0]
    return TupleColumns(*(np.concatenate([getattr(p, f) for p in parts]) for f in FIELDS))
