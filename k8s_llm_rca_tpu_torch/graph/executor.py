"""Graph query executors: one protocol, two backends.

``InMemoryGraphExecutor`` runs the mini-Cypher interpreter over a canned
Graph — the hermetic default.  ``Neo4jQueryExecutor`` is a thin param-safe
bolt client equivalent to the reference's (common/neo4j_query_executor.py:6-24),
import-gated so the hermetic path never touches the neo4j driver.

The port of ``k8s_llm_rca_tpu/graph/executor.py``.  Both backends carry
the same fault-injection point (``faults/inject.py``): when a FaultPlan is
armed, each ``run_query`` polls its ``fault_site`` before executing, so a
chaos run can schedule query failures, timeouts, slow calls, empty result
sets and poisoned payloads deterministically.  Disarmed, the check is one
module-attribute ``is None`` test.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Protocol

from k8s_llm_rca_tpu_torch.faults import inject
from k8s_llm_rca_tpu_torch.graph import cypher
from k8s_llm_rca_tpu_torch.graph.cypher import CypherSyntaxError  # noqa: F401 (re-export)
from k8s_llm_rca_tpu_torch.graph.store import Graph, Record
from k8s_llm_rca_tpu_torch.obs import trace as obs_trace

SITE_GRAPH = inject.SITE_GRAPH


class GraphQueryExecutor(Protocol):
    def run_query(self, query: str,
                  parameters: Optional[Dict[str, Any]] = None) -> List[Record]: ...
    def close(self) -> None: ...


class InMemoryGraphExecutor:
    def __init__(self, graph: Graph, fault_site: str = SITE_GRAPH):
        self.graph = graph
        self.fault_site = fault_site

    @classmethod
    def from_dump_file(cls, path: str) -> "InMemoryGraphExecutor":
        return cls(Graph.load(path))

    def run_query(self, query: str,
                  parameters: Optional[Dict[str, Any]] = None) -> List[Record]:
        with obs_trace.span("graph.query", cat="graph",
                            site=self.fault_site, query=query[:80]):
            if inject._ARMED is not None:
                fault = inject._ARMED.poll(self.fault_site)
                if fault is not None:
                    return inject.apply_query_fault(
                        fault, inject._ARMED,
                        lambda: cypher.run_query(self.graph, query,
                                                 parameters))
            return cypher.run_query(self.graph, query, parameters)

    def close(self) -> None:
        pass


class Neo4jQueryExecutor:
    """Bolt client matching the reference's executor surface: eager
    ``run_query`` returning list(records), ``close``, connectivity verified
    at construction (reference :7-9,15-24)."""

    def __init__(self, uri: str, user: str, password: str,
                 fault_site: str = SITE_GRAPH):
        from neo4j import GraphDatabase  # deferred: optional dependency

        self.driver = GraphDatabase.driver(uri, auth=(user, password))
        self.driver.verify_connectivity()
        self.fault_site = fault_site

    def _run(self, query: str, parameters: Optional[Dict[str, Any]]):
        with self.driver.session() as session:
            return list(session.run(query, parameters))

    def run_query(self, query: str,
                  parameters: Optional[Dict[str, Any]] = None):
        with obs_trace.span("graph.query", cat="graph",
                            site=self.fault_site, query=query[:80]):
            if inject._ARMED is not None:
                fault = inject._ARMED.poll(self.fault_site)
                if fault is not None:
                    return inject.apply_query_fault(
                        fault, inject._ARMED,
                        lambda: self._run(query, parameters))
            return self._run(query, parameters)

    def close(self) -> None:
        self.driver.close()
