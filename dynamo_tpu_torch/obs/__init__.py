"""The port's observability: the compile ledger of captured step programs
(``compile_ledger``) and the frontend's tracing — spans (``tracer``), the
flight recorder behind ``/debug/traces`` (``recorder``) and the
span→metrics bridge (``bridge``)."""
