"""Canned k8s metagraph + stategraph fixtures.

The reference has no offline fixtures at all — every run needs two live
Neo4j servers holding a Dec-2020 cluster dump that never shipped (SURVEY §4).
This module reconstructs an equivalent *synthetic* cluster implementing the
same data model (SURVEY §1 "Data model"):

- metagraph: one node per resource kind (``category`` =
  NativeEntity/ExternalEntity), edges typed HasEvent/ReferInternal/
  UseExternal carrying ``srcKind``/``destKind``/``key``;
- stategraph: lower-case entity nodes (kind/kind2/tag/id/isNative/isAtomic +
  the per-type name key name2|val|path|containerName|imageName), ``Event``
  entities linked to upper-case ``EVENT`` records via HasEvent(metadata_uid)
  and to the involved entity via ReferInternal(involvedObject_uid), and
  upper-case STATE nodes reached through HasState edges carrying the
  ``[tmin, tmax)`` validity interval.

Four incident scenarios cover the pipeline's distinct control paths:
missing-STATE audits (Secret, nfs), a healthy-but-misconfigured STATE
(ResourceQuota exhausted), the via-Namespace metapath rung, the undirected
rung (PV->PVC points against the Pod->PVC flow), and a decoy record for the
message-compatibility filter.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List

from k8s_llm_rca_tpu_torch.graph.store import Graph, Node

TS_EVENT = "2020-12-11 06:35:02.011"
TS_STATE_MIN = "2020-12-11 06:00:00.000"
TS_STATE_MAX = "2020-12-11 07:00:00.000"

NATIVE_KINDS = [
    "ConfigMap", "CronJob", "Deployment", "Job", "Namespace", "Node",
    "PersistentVolume", "PersistentVolumeClaim", "Pod", "ReplicaSet",
    "ResourceQuota", "Secret", "Service", "ServiceAccount", "StatefulSet",
]
EXTERNAL_KINDS = ["container", "hostPath", "image", "nfs"]

# (type, srcKind, destKind, key)
META_EDGES = [
    ("ReferInternal", "Pod", "Secret", "spec_volumes_secret_secretName"),
    ("ReferInternal", "Pod", "ConfigMap", "spec_volumes_configMap_name"),
    ("ReferInternal", "Pod", "PersistentVolumeClaim",
     "spec_volumes_persistentVolumeClaim_claimName"),
    ("ReferInternal", "PersistentVolume", "PersistentVolumeClaim",
     "spec_claimRef_uid"),
    ("ReferInternal", "Pod", "ServiceAccount", "spec_serviceAccountName"),
    ("ReferInternal", "Pod", "Node", "spec_nodeName"),
    ("ReferInternal", "Job", "Pod", "metadata_ownerReferences_uid"),
    ("ReferInternal", "CronJob", "Job", "metadata_ownerReferences_uid"),
    ("ReferInternal", "StatefulSet", "Pod", "metadata_ownerReferences_uid"),
    ("ReferInternal", "Pod", "Namespace", "metadata_namespace"),
    ("ReferInternal", "CronJob", "Namespace", "metadata_namespace"),
    ("ReferInternal", "ResourceQuota", "Namespace", "metadata_namespace"),
    ("UseExternal", "PersistentVolume", "nfs", "spec_nfs_path"),
    ("UseExternal", "PersistentVolume", "hostPath", "spec_hostPath_path"),
    ("UseExternal", "Pod", "container", "spec_containers_name"),
    ("UseExternal", "container", "image", "image"),
]


def build_metagraph() -> Graph:
    g = Graph()
    by_kind: Dict[str, Node] = {}
    for kind in NATIVE_KINDS:
        by_kind[kind] = g.add_node([kind], kind=kind, category="NativeEntity")
    for kind in EXTERNAL_KINDS:
        by_kind[kind] = g.add_node([kind], kind=kind, category="ExternalEntity")
    # Event participates in the graph but is excluded from the planning
    # vocabulary (the ladder also bars it from paths explicitly).
    by_kind["Event"] = g.add_node(["Event"], kind="Event", category="EventEntity")
    for type_, src, dest, key in META_EDGES:
        g.add_relationship(by_kind[src], type_, by_kind[dest],
                           srcKind=src, destKind=dest, key=key)
    return g


# ---------------------------------------------------------------------------
# incident corpus
# ---------------------------------------------------------------------------


@dataclass
class Incident:
    name: str
    message: str
    src_kind: str
    dest_kind: str
    relevant: List[str]
    # what a correct end-to-end run should surface
    expect_missing_state: List[str] = field(default_factory=list)
    expect_state_kinds: List[str] = field(default_factory=list)


INCIDENTS = [
    Incident(
        name="secret-not-found",
        message=('MountVolume.SetUp failed for volume "es-account-token" : '
                 'secret "es-account-token" not found'),
        src_kind="Pod",
        dest_kind="Secret",
        relevant=["Pod", "Secret"],
        expect_missing_state=["Secret"],
        expect_state_kinds=["Pod"],
    ),
    Incident(
        name="configmap-not-found",
        message=('MountVolume.SetUp failed for volume "gen-white-list-conf" : '
                 'configmap "es-gen-white-list-configmap" not found'),
        src_kind="Pod",
        dest_kind="ConfigMap",
        relevant=["Pod", "ConfigMap"],
        expect_missing_state=["ConfigMap"],
        expect_state_kinds=["Pod"],
    ),
    Incident(
        name="exceeded-quota",
        message=('Error creating: pods "es-cronjob-1607752440-gprx7" is '
                 'forbidden: exceeded quota: compute-resources-team1, '
                 'requested: pods=1, used: pods=50, limited: pods=50'),
        src_kind="CronJob",
        dest_kind="ResourceQuota",
        relevant=["CronJob", "ResourceQuota"],
        expect_missing_state=[],
        expect_state_kinds=["CronJob", "ResourceQuota"],
    ),
    Incident(
        name="nfs-no-such-file",
        message=('MountVolume.SetUp failed for volume "pvc-f3788c43" : mount '
                 'failed: exit status 32 Mounting command: systemd-run mount '
                 '-t nfs 172.16.112.63:/mnt/k8s_nfs_pv/redis-pv failed, '
                 'reason given by server: No such file or directory'),
        src_kind="Pod",
        dest_kind="nfs",
        relevant=["PersistentVolumeClaim", "PersistentVolume", "nfs"],
        expect_missing_state=["nfs"],
        expect_state_kinds=["Pod", "PersistentVolumeClaim",
                            "PersistentVolume"],
    ),
]


def _native(g: Graph, kind: str, name: str, uid: str) -> Node:
    return g.add_node([kind], kind=kind, kind2=kind, name2=name, id=uid,
                      isNative="true", isAtomic="false")


def _state(g: Graph, entity: Node, kind: str, uid: str,
           tmin: str = TS_STATE_MIN, tmax: str = TS_STATE_MAX,
           **fields) -> Node:
    props = {"kind": kind, "id": uid}
    props.update({k: (v if isinstance(v, str) else json.dumps(v))
                  for k, v in fields.items()})
    st = g.add_node([kind.upper()], **props)
    g.add_relationship(entity, "HasState", st, tmin=tmin, tmax=tmax)
    return st


def _event(g: Graph, message: str, involved: Node, uid: str) -> Node:
    ev = g.add_node(["Event"], kind="Event", kind2="Event", id=uid,
                    isNative="true", isAtomic="false",
                    timestamp=TS_EVENT, message=message,
                    nextTimestamp=TS_STATE_MAX)
    rec = g.add_node(["EVENT"], kind="EVENT", id=uid + "-rec",
                     message=message, timestamp=TS_EVENT)
    g.add_relationship(ev, "HasEvent", rec, key="metadata_uid")
    g.add_relationship(ev, "ReferInternal", involved, key="involvedObject_uid")
    return ev


def build_stategraph() -> Graph:
    g = Graph()

    # --- incident 1: missing Secret (plus a decoy healthy secret)
    pod1 = _native(g, "Pod", "es-pod-0", "pod-0001")
    secret1 = _native(g, "Secret", "es-account-token", "sec-0001")
    decoy = _native(g, "Secret", "other-secret", "sec-0002")
    g.add_relationship(pod1, "ReferInternal", secret1,
                       key="spec_volumes_secret_secretName")
    g.add_relationship(pod1, "ReferInternal", decoy,
                       key="spec_volumes_secret_secretName")
    _state(g, pod1, "Pod", "pod-0001",
           spec={"volumes": [{"secret": {"secretName": "es-account-token"}}]},
           status={"phase": "Pending", "conditions": [
               {"type": "Ready", "status": "False",
                "reason": "ContainersNotReady"}]},
           metadata={"name": "es-pod-0", "namespace": "es"})
    _state(g, decoy, "Secret", "sec-0002",
           data={"token": "<redacted>"},
           metadata={"name": "other-secret", "namespace": "es"})
    # secret1 deliberately has NO STATE node
    _event(g, INCIDENTS[0].message, pod1, "evt-0001")

    # --- incident 2: missing ConfigMap
    pod2 = _native(g, "Pod", "es-gen-pod", "pod-0002")
    cm1 = _native(g, "ConfigMap", "es-gen-white-list-configmap", "cm-0001")
    g.add_relationship(pod2, "ReferInternal", cm1,
                       key="spec_volumes_configMap_name")
    _state(g, pod2, "Pod", "pod-0002",
           spec={"volumes": [{"configMap": {"name":
                 "es-gen-white-list-configmap"}}]},
           status={"phase": "Pending"},
           metadata={"name": "es-gen-pod", "namespace": "es"})
    _event(g, INCIDENTS[1].message, pod2, "evt-0002")

    # --- incident 3: exhausted ResourceQuota, reached via Namespace
    cron1 = _native(g, "CronJob", "es-cronjob", "cron-0001")
    ns1 = _native(g, "Namespace", "team1", "ns-0001")
    quota1 = _native(g, "ResourceQuota", "compute-resources-team1", "rq-0001")
    g.add_relationship(cron1, "ReferInternal", ns1, key="metadata_namespace")
    g.add_relationship(quota1, "ReferInternal", ns1, key="metadata_namespace")
    _state(g, cron1, "CronJob", "cron-0001",
           spec={"schedule": "*/1 * * * *"},
           status={"active": 50},
           metadata={"name": "es-cronjob", "namespace": "team1"})
    _state(g, ns1, "Namespace", "ns-0001",
           spec={"finalizers": ["kubernetes"]},
           status={"phase": "Active"},
           metadata={"name": "team1"})
    _state(g, quota1, "ResourceQuota", "rq-0001",
           spec={"hard": {"pods": "50"}},
           status={"hard": {"pods": "50"}, "used": {"pods": "50"}},
           metadata={"name": "compute-resources-team1", "namespace": "team1"})
    _event(g, INCIDENTS[2].message, cron1, "evt-0003")

    # --- incident 4: nfs path gone; chain Pod->PVC<-PV->nfs (undirected rung)
    pod4 = _native(g, "Pod", "redis-0", "pod-0004")
    pvc1 = _native(g, "PersistentVolumeClaim", "redis-pvc", "pvc-0001")
    pv1 = _native(g, "PersistentVolume", "redis-pv", "pv-0001")
    nfs1 = g.add_node(["nfs"], kind="nfs", tag="nfs",
                      path="172.16.112.63:/mnt/k8s_nfs_pv/redis-pv",
                      id="nfs-0001", isNative="false", isAtomic="false")
    g.add_relationship(pod4, "ReferInternal", pvc1,
                       key="spec_volumes_persistentVolumeClaim_claimName")
    g.add_relationship(pv1, "ReferInternal", pvc1, key="spec_claimRef_uid")
    g.add_relationship(pv1, "UseExternal", nfs1, key="spec_nfs_path")
    _state(g, pod4, "Pod", "pod-0004",
           spec={"volumes": [{"persistentVolumeClaim":
                 {"claimName": "redis-pvc"}}]},
           status={"phase": "Running"},
           metadata={"name": "redis-0", "namespace": "redis"})
    _state(g, pvc1, "PersistentVolumeClaim", "pvc-0001",
           spec={"volumeName": "redis-pv"},
           status={"phase": "Bound"},
           metadata={"name": "redis-pvc", "namespace": "redis"})
    _state(g, pv1, "PersistentVolume", "pv-0001",
           spec={"nfs": {"server": "172.16.112.63",
                 "path": "/mnt/k8s_nfs_pv/redis-pv"}},
           status={"phase": "Bound"},
           metadata={"name": "redis-pv"})
    # nfs1 deliberately has NO STATE node
    _event(g, INCIDENTS[3].message, pod4, "evt-0004")

    return g
