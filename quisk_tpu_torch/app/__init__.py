"""Application layer: config, flags, the radio session, graph services,
CAT / TCI control, audio and mic devices, the web UI, MIDI, remote
operation, stations and the CLI."""
