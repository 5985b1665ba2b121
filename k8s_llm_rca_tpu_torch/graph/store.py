"""In-memory property graph.

The reference stores all graph data in two external Neo4j servers reached
over bolt (common/neo4j_query_executor.py; hardcoded IPs test_all.py:21-22)
and ships no fixtures, so nothing is testable offline (SURVEY §4).  This
store is the hermetic backend: the same node/relationship/path/record shapes
the neo4j driver exposes — stage code written against neo4j records runs
unchanged — plus JSON dump save/load so test fixtures are canned data, not a
live cluster.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple


class Node:
    """Property node.  Subscript access returns None for missing keys, like
    the neo4j driver's Node (reference relies on this: message_compatible
    probes dest['isNative'] etc. — generate_query/generate_query.py:112-127)."""

    __slots__ = ("element_id", "labels", "properties")

    def __init__(self, element_id: int, labels: Iterable[str],
                 properties: Dict[str, Any]):
        self.element_id = element_id
        self.labels = frozenset(labels)
        self.properties = dict(properties)

    def __getitem__(self, key: str) -> Any:
        return self.properties.get(key)

    def get(self, key: str, default: Any = None) -> Any:
        return self.properties.get(key, default)

    def keys(self):
        return self.properties.keys()

    def items(self):
        return self.properties.items()

    def __eq__(self, other) -> bool:
        return isinstance(other, Node) and other.element_id == self.element_id

    def __hash__(self) -> int:
        return hash(("node", self.element_id))

    def __repr__(self) -> str:
        return f"Node<{self.element_id} {set(self.labels)} {self.properties}>"


class Relationship:
    __slots__ = ("element_id", "type", "start_node", "end_node", "properties")

    def __init__(self, element_id: int, type_: str, start: Node, end: Node,
                 properties: Dict[str, Any]):
        self.element_id = element_id
        self.type = type_
        self.start_node = start
        self.end_node = end
        self.properties = dict(properties)

    def __getitem__(self, key: str) -> Any:
        return self.properties.get(key)

    def keys(self):
        return self.properties.keys()

    def items(self):
        return self.properties.items()

    def __eq__(self, other) -> bool:
        return isinstance(other, Relationship) and other.element_id == self.element_id

    def __hash__(self) -> int:
        return hash(("rel", self.element_id))

    def __repr__(self) -> str:
        return (f"Rel<{self.element_id} {self.type} "
                f"{self.start_node.element_id}->{self.end_node.element_id}>")


class Path:
    """len(path) == number of relationships, matching the neo4j driver
    (the reference's shortest-metapath pruning depends on it:
    find_metapath/find_srckind_metapath_neo4j.py:152-154)."""

    __slots__ = ("nodes", "relationships")

    def __init__(self, nodes: Sequence[Node], relationships: Sequence[Relationship]):
        self.nodes = tuple(nodes)
        self.relationships = tuple(relationships)

    def __len__(self) -> int:
        return len(self.relationships)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Path) and other.nodes == self.nodes
                and other.relationships == self.relationships)

    def __hash__(self) -> int:
        return hash((self.nodes, self.relationships))

    def __repr__(self) -> str:
        return f"Path<{[n['kind'] for n in self.nodes]}>"


class Record:
    """Query result row: indexable by position and by key, iterates over
    values — all three access styles the reference uses
    (record['n2.kind2'], record[len(record)-1], `for ele in record`)."""

    __slots__ = ("_keys", "_values")

    def __init__(self, keys: Sequence[str], values: Sequence[Any]):
        self._keys = list(keys)
        self._values = list(values)

    def __getitem__(self, key) -> Any:
        if isinstance(key, int):
            return self._values[key]
        return self._values[self._keys.index(key)]

    def __iter__(self) -> Iterator[Any]:
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def keys(self) -> List[str]:
        return list(self._keys)

    def values(self) -> List[Any]:
        return list(self._values)

    def data(self) -> Dict[str, Any]:
        return dict(zip(self._keys, self._values))

    def __repr__(self) -> str:
        return f"Record<{self.data()}>"


class Graph:
    """Mutable property graph with adjacency indexes."""

    def __init__(self):
        self._next_id = 0
        self.nodes: List[Node] = []
        self.relationships: List[Relationship] = []
        self._out: Dict[int, List[Relationship]] = {}
        self._in: Dict[int, List[Relationship]] = {}

    def add_node(self, labels: Iterable[str] = (), **properties) -> Node:
        node = Node(self._next_id, labels, properties)
        self._next_id += 1
        self.nodes.append(node)
        self._out[node.element_id] = []
        self._in[node.element_id] = []
        return node

    def add_relationship(self, start: Node, type_: str, end: Node,
                         **properties) -> Relationship:
        rel = Relationship(self._next_id, type_, start, end, properties)
        self._next_id += 1
        self.relationships.append(rel)
        self._out[start.element_id].append(rel)
        self._in[end.element_id].append(rel)
        return rel

    def out_rels(self, node: Node) -> List[Relationship]:
        return self._out.get(node.element_id, [])

    def in_rels(self, node: Node) -> List[Relationship]:
        return self._in.get(node.element_id, [])

    def nodes_with_label(self, label: Optional[str]) -> List[Node]:
        if label is None:
            return list(self.nodes)
        return [n for n in self.nodes if label in n.labels]

    # ------------------------------------------------------------ dump I/O

    def to_dump(self) -> Dict[str, Any]:
        return {
            "nodes": [
                {"id": n.element_id, "labels": sorted(n.labels),
                 "properties": n.properties}
                for n in self.nodes
            ],
            "relationships": [
                {"id": r.element_id, "type": r.type,
                 "start": r.start_node.element_id, "end": r.end_node.element_id,
                 "properties": r.properties}
                for r in self.relationships
            ],
        }

    @classmethod
    def from_dump(cls, dump: Dict[str, Any]) -> "Graph":
        g = cls()
        by_id: Dict[int, Node] = {}
        for nd in dump["nodes"]:
            node = Node(nd["id"], nd["labels"], nd["properties"])
            g.nodes.append(node)
            g._out[node.element_id] = []
            g._in[node.element_id] = []
            by_id[nd["id"]] = node
            g._next_id = max(g._next_id, nd["id"] + 1)
        for rd in dump["relationships"]:
            rel = Relationship(rd["id"], rd["type"], by_id[rd["start"]],
                               by_id[rd["end"]], rd["properties"])
            g.relationships.append(rel)
            g._out[rel.start_node.element_id].append(rel)
            g._in[rel.end_node.element_id].append(rel)
            g._next_id = max(g._next_id, rd["id"] + 1)
        return g

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dump(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "Graph":
        with open(path) as f:
            return cls.from_dump(json.load(f))
