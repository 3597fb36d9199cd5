"""Deterministic Workload names for owner jobs.

Equivalent of the reference's pkg/controller/jobframework/workload_names.go:
"<kind>-<jobname>-<hash suffix>" truncated to a DNS label.
"""

from __future__ import annotations

import hashlib

MAX_NAME_LENGTH = 63
HASH_LENGTH = 5


def workload_name_for_owner(owner_name: str, owner_uid: str, gvk: str) -> str:
    kind = gvk.rsplit("/", 1)[-1].lower()
    digest = hashlib.sha256(f"{gvk}/{owner_name}/{owner_uid}".encode()).hexdigest()
    suffix = digest[:HASH_LENGTH]
    prefix = f"{kind}-{owner_name}"
    if len(prefix) > MAX_NAME_LENGTH - HASH_LENGTH - 1:
        prefix = prefix[: MAX_NAME_LENGTH - HASH_LENGTH - 1]
    return f"{prefix}-{suffix}"
