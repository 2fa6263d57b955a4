"""Heartbeat / failover mask (swarm_tpu/coord/heartbeat.py)."""

from __future__ import annotations


def heartbeat_update(last_packet_t, now, timeout_s: float = 5.0):
    """online[i] = has ever spoken AND spoke within the timeout.
    last_packet_t [N] seconds, 0.0 = never heard."""
    return (last_packet_t > 0.0) & ((now - last_packet_t) <= timeout_s)
