"""Fault-tolerance pieces of the port: heartbeats, stragglers, preemption, retry."""

from repro_torch.ft.watchdog import HeartbeatMonitor, PreemptionSignal, StragglerWatchdog, with_retries
