"""Moving batches to the device, data parallelism across processes
(``mesh``, ``verify``) and the MoE dispatch."""
