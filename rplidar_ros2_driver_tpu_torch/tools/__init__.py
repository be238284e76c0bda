"""Tools: map and scan rendering (tools/viz.py); the launch path's host
cost per call on the card (tools/launch_cost.py)."""
