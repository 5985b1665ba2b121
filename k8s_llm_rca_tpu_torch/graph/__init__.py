from k8s_llm_rca_tpu_torch.graph.store import (  # noqa: F401
    Graph, Node, Relationship, Path, Record,
)
from k8s_llm_rca_tpu_torch.graph.executor import (  # noqa: F401
    GraphQueryExecutor, InMemoryGraphExecutor, Neo4jQueryExecutor,
    CypherSyntaxError,
)
