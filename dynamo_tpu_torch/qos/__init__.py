"""Request QoS pieces the engine's scheduler uses: deadline/priority
annotations and the weighted deficit-round-robin waiting queue."""
