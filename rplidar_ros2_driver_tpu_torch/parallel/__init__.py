"""Fleet scale-out: the (stream, beam) mesh (sharding.py), the
process-group bring-up (multihost.py) and the multi-stream service
(service.py)."""
