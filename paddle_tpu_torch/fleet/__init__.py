"""Generative-session state of the serving fleet (the port's copy of
``paddle_tpu.fleet.sessions``): session ids, prompt hashes, the bounded
session table and the resume-protocol validators that
``ServingClient.generate`` and the ``/generate`` handler follow.  The
router, the replica and the controller are not ported yet."""

from __future__ import annotations

from paddle_tpu_torch.fleet.sessions import SessionTable, new_session_id, \
    prompt_hash, validate_checkpoint, validate_stream_event

__all__ = ["SessionTable", "new_session_id", "prompt_hash",
           "validate_checkpoint", "validate_stream_event"]
