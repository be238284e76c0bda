"""The SLAM front-end mapper (mapping/mapper.FleetMapper)."""
