"""The port's observability: the compile ledger of captured step programs
(``compile_ledger``), the analytic cost model (``costmodel``) and the step
profiler over it (``profiler``), the scheduling and memory ledgers
(``sched_ledger``, ``mem_ledger``), and the tracing — spans (``tracer``),
the flight recorder behind ``/debug/traces`` with the engine's step ring
(``recorder``) and the span→metrics bridge (``bridge``)."""
