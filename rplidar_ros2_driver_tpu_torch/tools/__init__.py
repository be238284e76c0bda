"""Host-side tools: map and scan rendering (tools/viz.py)."""
