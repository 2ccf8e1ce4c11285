"""The paper's contributions: DDL, the topology-aware hierarchical
gradient reduction (`core/ddl`), and LMS, the memory planner and the host
side of its swap (`core/lms`; its executor is in `models/transformer.py`
and `train/steps.py`)."""
