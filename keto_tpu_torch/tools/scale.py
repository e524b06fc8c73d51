"""The scale tier's synthetic data, made entirely as numpy columns.

  synth_columns       a drive-style graph: folders with one owner each and
                      80 files a folder with a parent edge to it (the
                      cat-videos topology at scale), ~1% owner tuples
  synth_rbac_columns  a role-membership overlay for Expand: 12 direct
                      members and 2 nested roles a role

The same generators, seeds and columns as the JAX package's
tools/scale_bench.py (`synth_columns`, `synth_rbac_columns`), so both
packages load the same tuples; chip_smoke.py's phase 12 loads 1e7 of
them into a ColumnarStore.
"""

from __future__ import annotations

import numpy as np

from ..storage.columns import TupleColumns, concat_columns

FILES_PER_FOLDER = 80


def synth_columns(n_target: int, n_users: int, seed: int = 7):
    """(columns, folder names, each folder's owner, files a folder) of
    about n_target tuples: folder owners "u<k>" drawn from n_users, and
    every file /d<i>/v<j> a parent edge to its folder /d<i>."""
    files_per = FILES_PER_FOLDER
    n_folders = max(1, n_target // (files_per + 1))
    rng = np.random.default_rng(seed)

    folders = np.arange(n_folders)
    f_names = np.char.add("/d", folders.astype("U10"))
    owners = np.char.add("u", (rng.integers(0, n_users, n_folders)).astype("U10"))
    own = TupleColumns(
        ns=np.full(n_folders, "videos", "U6"), obj=f_names,
        rel=np.full(n_folders, "owner", "U6"), skind=np.zeros(n_folders, np.int8),
        sns=np.full(n_folders, "", "U1"), sobj=owners, srel=np.full(n_folders, "", "U1"),
    )
    n_files = n_folders * files_per
    parent_names = np.repeat(f_names, files_per)
    file_names = np.char.add(np.char.add(parent_names, "/v"),
                             np.tile(np.arange(files_per), n_folders).astype("U3"))
    par = TupleColumns(
        ns=np.full(n_files, "videos", "U6"), obj=file_names,
        rel=np.full(n_files, "parent", "U6"), skind=np.ones(n_files, np.int8),
        sns=np.full(n_files, "videos", "U6"), sobj=parent_names,
        srel=np.full(n_files, "...", "U3"),
    )
    return concat_columns([own, par]), f_names, owners, files_per


def synth_rbac_columns(n_roles: int, n_users: int, seed: int = 23) -> TupleColumns:
    """Role-membership columns of namespace "rbac": each role "role<k>"
    has 12 direct "u<k>" members and 2 nested roles of a higher id (the
    graph stays acyclic), so a depth-4 Expand of a role assembles a tree
    of ~40-100 nodes."""
    rng = np.random.default_rng(seed)
    members_per, nested_per = 12, 2
    n_direct = n_roles * members_per
    role_of = np.repeat(np.arange(n_roles), members_per)
    direct = TupleColumns(
        ns=np.full(n_direct, "rbac", "U4"), obj=np.char.add("role", role_of.astype("U7")),
        rel=np.full(n_direct, "member", "U6"), skind=np.zeros(n_direct, np.int8),
        sns=np.full(n_direct, "", "U1"),
        sobj=np.char.add("u", rng.integers(0, n_users, n_direct).astype("U10")),
        srel=np.full(n_direct, "", "U1"),
    )
    n_nest = n_roles * nested_per
    parent_role = np.repeat(np.arange(n_roles), nested_per)
    child_role = np.minimum(parent_role + 1 + rng.integers(0, 97, n_nest), n_roles - 1)
    nested = TupleColumns(
        ns=np.full(n_nest, "rbac", "U4"), obj=np.char.add("role", parent_role.astype("U7")),
        rel=np.full(n_nest, "member", "U6"), skind=np.ones(n_nest, np.int8),
        sns=np.full(n_nest, "rbac", "U4"), sobj=np.char.add("role", child_role.astype("U7")),
        srel=np.full(n_nest, "member", "U6"),
    )
    return concat_columns([direct, nested])
