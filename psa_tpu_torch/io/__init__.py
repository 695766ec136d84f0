"""Writers (the iSED LAMMPS dump)."""
