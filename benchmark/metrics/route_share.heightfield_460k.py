"""route_share.heightfield_460k: the resident tables' bytes over the card's
streaming budget, in percent, from the port's route counters
(``route.table_bytes`` over ``route.budget_bytes``), read as
``route_share.terrain_big`` reads them.  Above 100 the tables take the
streamed layout.  None where the program keeps no such counters."""

from benchmark import spec

read = spec.reader("route_share.terrain_big")
