"""Local multi-device sharding (the mesh) and the multi-host file protocol."""
