"""The paper's contributions as the port has them so far: DDL, the
topology-aware hierarchical gradient reduction (`core/ddl`). LMS is not
ported yet."""
