"""Shared stategraph entity data-model dispatch.

The reference repeats the per-type name-key switch in three places
(generate_query/generate_query.py:112-127, check_state/analyze_root_cause.py
:210-219 and implicitly :97-101); here it lives once.

- native entities carry ``name2``; atomic externals carry ``val``;
  nfs/hostPath carry ``path``; containers ``containerName``; images
  ``imageName``;
- an entity's *kind* is ``kind2`` for natives and ``tag`` for externals.
"""

from __future__ import annotations

from typing import Optional


def entity_name_key(node) -> Optional[str]:
    """The property holding a stategraph entity's human name, or None."""
    if node["isNative"] == "true":
        return "name2"
    if node["isAtomic"] == "true":
        return "val"
    if node["tag"] in ("nfs", "hostPath"):
        return "path"
    if node["tag"] == "container":
        return "containerName"
    if node["tag"] == "image":
        return "imageName"
    return None


def entity_kind_key(node) -> str:
    """The property holding the entity's kind name."""
    return "kind2" if node["isNative"] == "true" else "tag"


def entity_name(node, default: Optional[str] = None) -> Optional[str]:
    key = entity_name_key(node)
    return node[key] if key else default


def entity_kind(node) -> str:
    return node[entity_kind_key(node)]
