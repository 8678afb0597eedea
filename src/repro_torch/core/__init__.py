"""Core of the torch port: word layout, SPARQL front end, SOI, fixpoints."""
