"""Runtime proto message classes from the package's own descriptor set.

`protos/` holds the six `.proto` files of the v1alpha2 API and the
keto_tpu extensions, and `protos/keto_descriptors.binpb`, the compiled
FileDescriptorSet, byte for byte the JAX package's. The message classes
are made at import time from a private descriptor pool over that set, so
the port needs no generated `*_pb2.py` code and no `protoc`, and its
messages are the JAX package's whatever protobuf a machine has.

The fully qualified service names below are the gRPC routes
(`/<service>/<method>`): the wire contract with existing clients.
"""

from __future__ import annotations

import pathlib
from types import SimpleNamespace

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

_PKG = "ory.keto.relation_tuples.v1alpha2"
PROTO_DIR = pathlib.Path(__file__).parent / "protos"
DESCRIPTOR_FILE = PROTO_DIR / "keto_descriptors.binpb"

# a private pool, not the process default: an application that also
# loads Keto's generated *_pb2 modules meets no duplicate symbol
_pool = descriptor_pool.DescriptorPool()
_fds = descriptor_pb2.FileDescriptorSet()
_fds.ParseFromString(DESCRIPTOR_FILE.read_bytes())
for _f in _fds.file:
    _pool.Add(_f)


def _msg(full_name: str):
    return message_factory.GetMessageClass(_pool.FindMessageTypeByName(full_name))


def _keto(name: str):
    return _msg(f"{_PKG}.{name}")


pb = SimpleNamespace(
    RelationTuple=_keto("RelationTuple"),
    RelationQuery=_keto("RelationQuery"),
    Subject=_keto("Subject"),
    SubjectSet=_keto("SubjectSet"),
    SubjectTree=_keto("SubjectTree"),
    CheckRequest=_keto("CheckRequest"),
    CheckResponse=_keto("CheckResponse"),
    ExpandRequest=_keto("ExpandRequest"),
    ExpandResponse=_keto("ExpandResponse"),
    ListRelationTuplesRequest=_keto("ListRelationTuplesRequest"),
    ListRelationTuplesResponse=_keto("ListRelationTuplesResponse"),
    TransactRelationTuplesRequest=_keto("TransactRelationTuplesRequest"),
    TransactRelationTuplesResponse=_keto("TransactRelationTuplesResponse"),
    RelationTupleDelta=_keto("RelationTupleDelta"),
    DeleteRelationTuplesRequest=_keto("DeleteRelationTuplesRequest"),
    DeleteRelationTuplesResponse=_keto("DeleteRelationTuplesResponse"),
    GetVersionRequest=_keto("GetVersionRequest"),
    GetVersionResponse=_keto("GetVersionResponse"),
    HealthCheckRequest=_msg("grpc.health.v1.HealthCheckRequest"),
    HealthCheckResponse=_msg("grpc.health.v1.HealthCheckResponse"),
    # keto_tpu extensions (additive; not in Keto's API)
    BatchCheckRequest=_msg("keto_tpu.batch.v1.BatchCheckRequest"),
    BatchCheckResult=_msg("keto_tpu.batch.v1.BatchCheckResult"),
    BatchCheckResponse=_msg("keto_tpu.batch.v1.BatchCheckResponse"),
    ListObjectsRequest=_msg("keto_tpu.reverse.v1.ListObjectsRequest"),
    ListObjectsResponse=_msg("keto_tpu.reverse.v1.ListObjectsResponse"),
    ListSubjectsRequest=_msg("keto_tpu.reverse.v1.ListSubjectsRequest"),
    ListSubjectsResponse=_msg("keto_tpu.reverse.v1.ListSubjectsResponse"),
    FilterRequest=_msg("keto_tpu.filter.v1.FilterRequest"),
    FilterResponse=_msg("keto_tpu.filter.v1.FilterResponse"),
    # the tuple change-log stream (keto_tpu_watch.proto)
    WatchRequest=_msg("keto_tpu.watch.v1.WatchRequest"),
    WatchChange=_msg("keto_tpu.watch.v1.WatchChange"),
    WatchResponse=_msg("keto_tpu.watch.v1.WatchResponse"),
)

NODE_TYPE = _pool.FindEnumTypeByName(f"{_PKG}.NodeType")
ACTION = pb.RelationTupleDelta.DESCRIPTOR.enum_types_by_name["Action"]
SERVING_STATUS = pb.HealthCheckResponse.DESCRIPTOR.enum_types_by_name["ServingStatus"]

CHECK_SERVICE = f"{_PKG}.CheckService"
EXPAND_SERVICE = f"{_PKG}.ExpandService"
READ_SERVICE = f"{_PKG}.ReadService"
WRITE_SERVICE = f"{_PKG}.WriteService"
VERSION_SERVICE = f"{_PKG}.VersionService"
HEALTH_SERVICE = "grpc.health.v1.Health"
BATCH_CHECK_SERVICE = "keto_tpu.batch.v1.BatchCheckService"
REVERSE_READ_SERVICE = "keto_tpu.reverse.v1.ReverseReadService"
FILTER_SERVICE = "keto_tpu.filter.v1.FilterService"
# the tuple change-log stream, served from the Watch hub (watch/hub.py)
WATCH_SERVICE = "keto_tpu.watch.v1.WatchService"
