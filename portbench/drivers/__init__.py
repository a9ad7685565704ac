"""The gateway, audit and restoral drivers, one per kind of traffic."""
