"""The fault-tolerant MapReduce master the port's executor runs on."""
from .mapreduce import MapReduceRunner, TaskResult, WorkerPool

__all__ = ["MapReduceRunner", "WorkerPool", "TaskResult"]
