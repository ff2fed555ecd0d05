"""The port's multi-rank layer: sharding rules, collective accounting, the
GPipe pipeline and the rank launcher."""
