// C++ CPU reference engine: a self-contained discrete-event simulator for the
// three consensus protocols (PBFT / Raft / Paxos).
//
// Role (SURVEY.md §7 L6): the TPU framework's independent cross-check.  The
// upstream reference is an ns-3 application (C++ against Simulator::Schedule /
// UDP socket models, SURVEY.md §1 L1); this engine replaces that external
// dependency with ~700 lines: a binary-heap event queue over virtual
// millisecond time, per-node protocol FSMs, and the same per-message random
// delay model (delay = link propagation + per-protocol uniform draw,
// pbft-node.cc:66-69, raft-node.cc:63-66, paxos-node.cc:397-400).
//
// Unlike the JAX backends — which tensorize aggressively (count-consumed
// channels, short-circuited round trips, slotted 1 ms ticks) — this engine
// implements the *literal* per-message flow: every PREPARE is delivered to
// every peer, every PREPARE_RES is a separate unicast event, exactly as the
// reference's HandleRead FSMs do (pbft-node.cc:167, raft-node.cc:128,
// paxos-node.cc:149).  Differential tests (tests/test_differential.py) check
// that both engines reach the same consensus milestones and satisfy the same
// safety invariants under the same fidelity mode.
//
// Fidelity modes mirror utils/config.py:
//   reference: N/2 thresholds, reset-on-threshold counters (quirk #4), Raft
//     election timer canceled-never-re-armed (quirk #5), Paxos skip-first-peer
//     broadcasts + shared cross-phase counters closing at exactly N-2 replies
//     (quirks #7/#8).
//   clean: latched commits, re-armed timers, Paxos self-promise + true
//     majority + jittered timeout-only retries + highest-t_store adoption.
//
// Deliberate divergences from the upstream reference (documented, both
// fidelity modes): no echo-back (quirk #1 — reflecting every packet to its
// sender makes packets ping-pong forever, so the upstream event queue never
// drains; nothing meaningful depends on it), per-node protocol state instead
// of PBFT's accidental process-globals (quirk #10), and no dangling-pointer /
// end()-dereference UB (quirks #8/#9).
//
// Build: g++ -O2 -shared -fPIC (driven by engine/__init__.py); interface is a
// flat C struct + JSON-out extern "C" call consumed via ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <random>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// config (field order must match blockchain_simulator_tpu/engine/__init__.py)
// ---------------------------------------------------------------------------
struct SimCfg {
  int32_t protocol;  // 0 pbft, 1 raft, 2 paxos
  int32_t n;
  int32_t sim_ms;
  int64_t seed;
  int32_t fidelity;  // 0 reference, 1 clean
  int32_t delay_lo;  // one-way delay lower bound, ms (link + protocol draw)
  int32_t delay_hi;  // exclusive upper bound
  int32_t pbft_interval;
  int32_t pbft_max_rounds;
  int32_t pbft_slots;
  int32_t pbft_vc_num;
  int32_t pbft_vc_den;
  int32_t raft_hb;
  int32_t raft_elo;
  int32_t raft_ehi;
  int32_t raft_prop_delay;
  int32_t raft_max_blocks;
  int32_t raft_max_rounds;
  int32_t paxos_p;
  int32_t paxos_max_ticket;
  int32_t paxos_timeout;
  int32_t n_crashed;
  int32_t n_byzantine;
  double drop_prob;
  // serialization delay (ticks) added to block-carrying messages: the
  // reference's 3 Mbps links take ~136 ms to serialize a 50 KB PBFT block
  // (blockchain-simulator.cc:22-24, pbft-node.cc:377-380) and ~54 ms for a
  // 20 KB Raft proposal (raft-node.cc:409).  Links are NOT queued: the
  // serialization term is a constant latency per message, matching the JAX
  // engines (see SimConfig.model_serialization).
  int32_t ser_pbft;
  int32_t ser_raft;
  // Queued-link transport (ns-3 fidelity): each directed (from, to) link is
  // a serial 3 Mbps pipe — a packet's transmission starts when the link is
  // free (max(ready, busy_until)), occupies it for its serialization time,
  // then propagates.  The constant-latency default charges serialization as
  // a fixed per-message term instead; at reference PBFT defaults that is a
  // real divergence (a 50 KB block serializes ~136 ms but blocks depart
  // every 50 ms, so the upstream's per-link queues grow ~86 ms per round —
  // tests/test_fidelity.py quantifies it).  0 = constant-latency (default,
  // matches the JAX engines); 1 = queued.
  int32_t queued_links;
  int32_t link_prop;  // propagation ms (blockchain-simulator.cc:24); the
  // random scheduling delay is delay() - link_prop (one_way_range collapses
  // sched + prop into [delay_lo, delay_hi))
  // quirk #1 fidelity (bounded): reflect every received packet back to its
  // sender ONCE (pbft-node.cc:175, raft-node.cc:136, paxos-node.cc:158).
  // The upstream reflects unconditionally, so reflections of reflections
  // ping-pong forever and its event queue never drains; here a reflected
  // copy is marked and never re-reflected — the receiver still processes it
  // through the normal FSM exactly as the upstream HandleRead would (echoed
  // PREPAREs draw PREPARE_RES replies, echoed requests draw responses, the
  // rest lands in the "wrong msg" default), reproducing the upstream's
  // traffic inflation to first order.  0 = off (default; the JAX engines
  // never model echo — tests/test_fidelity.py pins the delta).
  int32_t echo;
  // Paxos CLIENT_PROPOSE external-client hook (paxos-node.cc:357-361):
  // proposer lane `paxos_client_node` (< paxos_p; -1 = none) does not fire
  // requireTicket at t=0 — a simulated client triggers it at
  // `paxos_client_ms` instead.
  int32_t paxos_client_node;
  int32_t paxos_client_ms;
};

// ---------------------------------------------------------------------------
// event queue: (time, seq) ordered min-heap — the stand-in for ns-3's
// Simulator::Schedule/Run (SURVEY.md C12).  seq preserves FIFO order among
// same-time events, matching ns-3's scheduler semantics.
// ---------------------------------------------------------------------------
struct Msg {
  int32_t type;
  int32_t from;
  int32_t a, b, c;  // protocol-specific fields (view/slot/ticket/command/...)
  int32_t refl;     // 1 = an echo reflection (never re-reflected; cfg.echo)
  int32_t ser;      // this message's serialization ticks (set by send();
                    // reflections reuse it so echoed blocks keep block timing)
};

struct Event {
  int64_t t;
  int64_t seq;
  int32_t node;   // receiver (message/enqueue) or owner (timer)
  int32_t kind;   // 0 = message delivery, 1 = timer, 2 = link enqueue
  int32_t timer;  // timer id when kind == 1
  Msg msg;        // payload when kind == 0 or 2
};

struct EventCmp {
  bool operator()(const Event& x, const Event& y) const {
    if (x.t != y.t) return x.t > y.t;
    return x.seq > y.seq;
  }
};

class Sim;

// per-protocol node base ----------------------------------------------------
struct NodeBase {
  int32_t id = 0;
  bool alive = true;
  bool honest = true;
};

// ---------------------------------------------------------------------------
// simulator core
// ---------------------------------------------------------------------------
class Sim {
 public:
  explicit Sim(const SimCfg& c) : cfg(c), rng(static_cast<uint64_t>(c.seed)) {
    if (c.queued_links)
      busy_until.assign(static_cast<size_t>(c.n) * c.n, 0);
  }

  const SimCfg cfg;
  std::mt19937_64 rng;
  std::priority_queue<Event, std::vector<Event>, EventCmp> q;
  int64_t now = 0;
  int64_t seq = 0;
  int64_t delivered = 0;  // messages processed (traffic metric; echo tests)
  std::vector<int64_t> busy_until;  // per directed edge, queued_links mode

  int32_t rand_int(int32_t lo, int32_t hi) {  // uniform in [lo, hi); hi<=lo → lo
    if (hi <= lo) return lo;
    return lo + static_cast<int32_t>(rng() % static_cast<uint64_t>(hi - lo));
  }
  bool dropped() {
    if (cfg.drop_prob <= 0.0) return false;
    return std::uniform_real_distribution<double>(0.0, 1.0)(rng) < cfg.drop_prob;
  }
  int32_t delay() { return rand_int(cfg.delay_lo, cfg.delay_hi); }

  void schedule_msg(int32_t to, const Msg& m, int32_t d) {
    q.push(Event{now + d, seq++, to, 0, 0, m});
  }
  void schedule_timer(int32_t node, int32_t timer, int64_t at) {
    q.push(Event{at, seq++, node, 1, timer, Msg{}});
  }
  // unicast with a fresh delay draw + drop roll (the reference defers every
  // send via Simulator::Schedule(getRandomDelay(), ...), SURVEY.md C8).
  // ``extra`` is the message's serialization time (0 for 3-4-byte votes).
  void send(int32_t to, const Msg& m, int32_t extra = 0) {
    if (dropped()) return;
    Msg mm = m;
    mm.ser = extra;
    if (cfg.queued_links) {
      // ns-3 transport: after the random scheduling delay the packet REACHES
      // the serial (from, to) link; the link is reserved at that moment — in
      // link-arrival order, not send-call order (two sends whose scheduling
      // draws invert must transmit in arrival order) — so the reservation
      // runs as its own event (kind 2 in run_loop).  The scheduling term is
      // delay() - link_prop; one_way_range on the Python side guarantees
      // delay_lo >= link_prop, but clamp to 0 so no config path can ever
      // enqueue an event in the past and walk sim.now backwards (ADVICE r4)
      q.push(Event{now + std::max(delay() - cfg.link_prop, 0), seq++, to, 2,
                   0, mm});
      return;
    }
    schedule_msg(to, mm, delay() + extra);
  }
  // kind-2 handler: reserve the link now, deliver after transmit + propagate
  void link_enqueue(int32_t to, const Msg& m) {
    int64_t& busy = busy_until[static_cast<size_t>(m.from) * cfg.n + to];
    int64_t start = std::max(now, busy);
    busy = start + m.ser;
    schedule_msg(to, m, static_cast<int32_t>(start + m.ser + cfg.link_prop - now));
  }
  // broadcast to all peers except self (and optionally except the sender's
  // first peer — the Paxos iterator bug, paxos-node.cc:478-496)
  void bcast(int32_t from, const Msg& m, bool skip_first_peer = false,
             int32_t extra = 0) {
    int32_t first = (from == 0) ? 1 : 0;
    for (int32_t to = 0; to < cfg.n; ++to) {
      if (to == from) continue;
      if (skip_first_peer && to == first) continue;
      send(to, m, extra);
    }
  }
};

// ---------------------------------------------------------------------------
// PBFT (pbft/pbft-node.cc; JAX twin: models/pbft.py)
// ---------------------------------------------------------------------------
namespace pbft {
enum { PRE_PREPARE = 1, PREPARE = 2, COMMIT = 3, PREPARE_RES = 5, VIEW_CHANGE = 8 };
enum { T_SENDBLOCK = 0 };

struct Node : NodeBase {
  int32_t v = 1, leader = 0, next_n = 0, rounds_sent = 0;
  int32_t block_num = 0, view_changes = 0;
  std::vector<int32_t> tx_val, prepare_vote, commit_vote, commit_tick;
  std::vector<uint8_t> prep_sent, committed;
};

struct Engine {
  Sim sim;
  std::vector<Node> nodes;
  // first actual broadcast tick per slot (models/pbft.py slot_propose_tick):
  // with a view change + in-flight serialization, a new leader re-proposes
  // stale slots, so slot s is NOT proposed at (s+1)*interval in general
  std::vector<int32_t> propose_tick;
  explicit Engine(const SimCfg& c) : sim(c) {
    int32_t s = c.pbft_slots;
    propose_tick.assign(s, -1);
    nodes.resize(c.n);
    for (int32_t i = 0; i < c.n; ++i) {
      Node& nd = nodes[i];
      nd.id = i;
      nd.alive = i < c.n - c.n_crashed;
      nd.honest = i < c.n - c.n_crashed - c.n_byzantine;
      nd.tx_val.assign(s, -1);
      nd.prepare_vote.assign(s, 0);
      nd.commit_vote.assign(s, 0);
      nd.commit_tick.assign(s, -1);
      nd.prep_sent.assign(s, 0);
      nd.committed.assign(s, 0);
      // every node self-schedules SendBlock every 50 ms (pbft-node.cc:155,406)
      if (nd.alive) sim.schedule_timer(i, T_SENDBLOCK, c.pbft_interval);
    }
  }

  void on_timer(Node& nd, int32_t, int64_t) {
    const SimCfg& c = sim.cfg;
    if (!nd.alive) return;
    // SendBlock (pbft-node.cc:372-411)
    if (nd.id == nd.leader && nd.next_n < std::min(c.pbft_max_rounds, c.pbft_slots)) {
      Msg m{PRE_PREPARE, nd.id, nd.v, nd.next_n, nd.next_n};  // val == n
      sim.bcast(nd.id, m, false, c.ser_pbft);  // 50 KB block serialization
      if (nd.next_n < c.pbft_slots && propose_tick[nd.next_n] < 0)
        propose_tick[nd.next_n] = static_cast<int32_t>(sim.now);
      nd.rounds_sent++;
      nd.next_n++;
      // random view change, P = num/den per leader round (pbft-node.cc:401-403)
      if (sim.rand_int(0, c.pbft_vc_den) < c.pbft_vc_num) {
        nd.v += 1;
        nd.leader = (nd.leader + 1) % c.n;
        nd.view_changes++;
        Msg vc{VIEW_CHANGE, nd.id, nd.v, nd.leader, 0};
        sim.bcast(nd.id, vc);
      }
    }
    sim.schedule_timer(nd.id, T_SENDBLOCK, sim.now + c.pbft_interval);
  }

  void on_msg(Node& nd, const Msg& m) {
    const SimCfg& c = sim.cfg;
    bool clean = c.fidelity == 1;
    int32_t quorum = c.n / 2;
    switch (m.type) {
      case PRE_PREPARE: {  // store value, broadcast PREPARE (pbft-node.cc:193-211)
        int32_t slot = m.b;
        if (slot >= c.pbft_slots) break;
        nd.tx_val[slot] = m.c;
        nd.next_n = std::max(nd.next_n, slot + 1);
        sim.bcast(nd.id, Msg{PREPARE, nd.id, m.a, slot, 0});
        break;
      }
      case PREPARE: {  // unconditional SUCCESS reply (pbft-node.cc:212-221);
        // Byzantine nodes flip their vote (delivered as FAILED, i.e. dropped
        // from the counter — matching models/pbft.py voters mask)
        if (nd.honest) sim.send(m.from, Msg{PREPARE_RES, nd.id, m.a, m.b, 0});
        break;
      }
      case PREPARE_RES: {  // count → COMMIT broadcast (pbft-node.cc:223-240)
        int32_t slot = m.b;
        if (slot >= c.pbft_slots) break;
        nd.prepare_vote[slot]++;
        bool crossed = nd.prepare_vote[slot] >= quorum;
        if (crossed && clean && nd.prep_sent[slot]) break;
        if (crossed) {
          nd.prep_sent[slot] = 1;
          nd.prepare_vote[slot] = 0;  // reset-on-threshold (quirk #4)
          if (nd.honest) sim.bcast(nd.id, Msg{COMMIT, nd.id, m.a, slot, 0});
        }
        break;
      }
      case COMMIT: {  // count → finality (pbft-node.cc:241-265)
        int32_t slot = m.b;
        if (slot >= c.pbft_slots) break;
        nd.commit_vote[slot]++;
        bool crossed = nd.commit_vote[slot] > quorum;
        if (crossed && clean && nd.committed[slot]) break;
        if (crossed) {
          nd.commit_vote[slot] = 0;
          if (nd.commit_tick[slot] < 0) nd.commit_tick[slot] = static_cast<int32_t>(sim.now);
          nd.committed[slot] = 1;
          nd.block_num++;
        }
        break;
      }
      case VIEW_CHANGE: {  // adopt (v, leader) (pbft-node.cc:271-280)
        nd.v = m.a;
        nd.leader = m.b;
        break;
      }
    }
  }
};
}  // namespace pbft

// ---------------------------------------------------------------------------
// Raft (raft/raft-node.cc; JAX twin: models/raft.py)
// ---------------------------------------------------------------------------
namespace raft {
enum { VOTE_REQ = 2, VOTE_RES = 3, HEARTBEAT = 4, HEARTBEAT_RES = 5 };
enum { HB_PLAIN = 0, HB_PROPOSAL = 1 };
enum { T_ELECTION = 0, T_HEARTBEAT = 1, T_SETPROP = 2 };

struct Node : NodeBase {
  bool is_leader = false, has_voted = false, add_change_value = false;
  int32_t vote_success = 0, vote_failed = 0;
  int32_t m_value = -1, block_num = 0, round = 0;
  int32_t hb_succ = 0, hb_cnt = 0;
  bool hb_open = false;
  int32_t leader_tick = -1, elections = 0;
  int64_t election_gen = 0;   // cancellation token for the election timer
  int64_t heartbeat_gen = 0;  // cancellation token for the heartbeat timer
  std::vector<int32_t> block_tick;
};

struct Engine {
  Sim sim;
  std::vector<Node> nodes;
  explicit Engine(const SimCfg& c) : sim(c) {
    nodes.resize(c.n);
    for (int32_t i = 0; i < c.n; ++i) {
      Node& nd = nodes[i];
      nd.id = i;
      nd.alive = i < c.n - c.n_crashed;
      nd.honest = i < c.n - c.n_crashed - c.n_byzantine;
      nd.block_tick.assign(c.raft_max_blocks, -1);
      if (nd.alive)  // initial election timeout U[150,300) (raft-node.cc:114)
        sim.schedule_timer(i, T_ELECTION, sim.rand_int(c.raft_elo, c.raft_ehi));
    }
  }

  void arm_election(Node& nd) {
    nd.election_gen = sim.seq;  // newest schedule wins; older firings ignored
    sim.schedule_timer(nd.id, T_ELECTION,
                       sim.now + sim.rand_int(sim.cfg.raft_elo, sim.cfg.raft_ehi));
  }

  void send_heartbeat(Node& nd) {  // sendHeartBeat (raft-node.cc:405-433)
    const SimCfg& c = sim.cfg;
    if (nd.add_change_value) {
      // 20 KB proposal block serialization (raft-node.cc:409)
      sim.bcast(nd.id, Msg{HEARTBEAT, nd.id, HB_PROPOSAL, nd.id, 0}, false,
                c.ser_raft);
      nd.round++;  // SendTX round++ (raft-node.cc:360-365)
      if (nd.round >= c.raft_max_rounds) nd.add_change_value = false;
      if (c.fidelity == 1) {
        nd.hb_succ = nd.hb_cnt = 0;
        nd.hb_open = true;
      }
    } else {
      sim.bcast(nd.id, Msg{HEARTBEAT, nd.id, HB_PLAIN, 0, 0});
    }
    nd.heartbeat_gen = sim.seq;
    sim.schedule_timer(nd.id, T_HEARTBEAT, sim.now + c.raft_hb);
  }

  void on_timer(Node& nd, int32_t timer, int64_t gen) {
    const SimCfg& c = sim.cfg;
    if (!nd.alive) return;
    switch (timer) {
      case T_ELECTION: {  // sendVote (raft-node.cc:392-401)
        if (gen < nd.election_gen || nd.is_leader) return;  // canceled/re-armed
        nd.has_voted = true;  // self-vote latch
        nd.elections++;
        sim.bcast(nd.id, Msg{VOTE_REQ, nd.id, nd.id, 0, 0});
        arm_election(nd);
        break;
      }
      case T_HEARTBEAT: {
        if (gen < nd.heartbeat_gen || !nd.is_leader) return;
        if (nd.block_num >= c.raft_max_blocks) return;  // canceled (raft-node.cc:248)
        send_heartbeat(nd);
        break;
      }
      case T_SETPROP: {  // setProposal (raft-node.cc:431-433)
        nd.add_change_value = true;
        break;
      }
    }
  }

  void on_msg(Node& nd, const Msg& m) {
    const SimCfg& c = sim.cfg;
    bool clean = c.fidelity == 1;
    int32_t quorum = c.n / 2;
    switch (m.type) {
      case VOTE_REQ: {  // grant iff !has_voted (raft-node.cc:154-167)
        bool grant = !nd.has_voted;
        if (grant) nd.has_voted = true;
        bool wire_ok = nd.honest ? grant : !grant;  // Byzantine flip
        sim.send(m.from, Msg{VOTE_RES, nd.id, wire_ok ? 1 : 0, 0, 0});
        break;
      }
      case VOTE_RES: {  // candidate counting (raft-node.cc:196-232)
        if (nd.is_leader) break;
        if (m.a) nd.vote_success++; else nd.vote_failed++;
        if (m.a && nd.vote_success + 1 > quorum) {  // win
          nd.vote_success = nd.vote_failed = 0;
          nd.is_leader = true;
          nd.election_gen = sim.seq;  // cancel own timer (raft-node.cc:214)
          if (nd.leader_tick < 0) nd.leader_tick = static_cast<int32_t>(sim.now);
          sim.schedule_timer(nd.id, T_SETPROP, sim.now + c.raft_prop_delay);
          send_heartbeat(nd);
        } else if (!m.a && nd.vote_failed >= quorum) {  // lose → retry
          nd.vote_success = nd.vote_failed = 0;
          nd.has_voted = false;
        }
        break;
      }
      case HEARTBEAT: {  // follower (raft-node.cc:170-193)
        if (m.a == HB_PROPOSAL) nd.m_value = m.b;
        if (clean) arm_election(nd);           // real failure detection
        else nd.election_gen = sim.seq;        // quirk #5: canceled forever
        // reply; Byzantine followers flip proposal acks
        if (m.a == HB_PROPOSAL) {
          int32_t ok = nd.honest ? 1 : 0;
          sim.send(m.from, Msg{HEARTBEAT_RES, nd.id, HB_PROPOSAL, ok, 0});
        } else {
          sim.send(m.from, Msg{HEARTBEAT_RES, nd.id, HB_PLAIN, 1, 0});
        }
        break;
      }
      case HEARTBEAT_RES: {  // leader ack counting (raft-node.cc:234-251)
        if (m.a != HB_PROPOSAL || !nd.is_leader) break;
        nd.hb_cnt++;
        if (m.b) nd.hb_succ++;
        bool commit;
        if (clean) {
          commit = nd.hb_open && nd.hb_succ + 1 > quorum;
          if (commit) nd.hb_open = false;
        } else {  // check only at exactly N-1 responses
          commit = (nd.hb_cnt == c.n - 1) && (nd.hb_succ + 1 > quorum);
          if (nd.hb_cnt == c.n - 1) nd.hb_succ = nd.hb_cnt = 0;
        }
        if (commit && nd.block_num < c.raft_max_blocks) {
          nd.block_tick[nd.block_num] = static_cast<int32_t>(sim.now);
          nd.block_num++;
        }
        break;
      }
    }
  }
};
}  // namespace raft

// ---------------------------------------------------------------------------
// Paxos (paxos/paxos-node.cc; JAX twin: models/paxos.py)
// ---------------------------------------------------------------------------
namespace paxos {
enum {
  REQUEST_TICKET = 0, REQUEST_PROPOSE = 1, REQUEST_COMMIT = 2,
  RESPONSE_TICKET = 3, RESPONSE_PROPOSE = 4, RESPONSE_COMMIT = 5,
};
enum { T_START = 0, T_WINDOW = 1 };

struct Node : NodeBase {
  // acceptor (paxos-node.h:40-43)
  int32_t t_max = 0, command = -1, t_store = 0;
  bool is_commit = false;
  int32_t exec_tick = -1;
  // proposer
  int32_t ticket = 0, phase = -1;  // 0 wt, 1 wp, 2 wc, 3 done
  int32_t vote_success = 0, vote_failed = 0;
  int32_t proposal = 0;
  int32_t adopt_t = -1, adopt_cmd = -1;  // clean: highest-t_store promise
  int32_t commit_tick = -1;
  bool gave_up = false;
  int64_t window_gen = 0;  // clean: timeout cancellation token
};

struct Engine {
  Sim sim;
  std::vector<Node> nodes;
  explicit Engine(const SimCfg& c) : sim(c) {
    nodes.resize(c.n);
    for (int32_t i = 0; i < c.n; ++i) {
      Node& nd = nodes[i];
      nd.id = i;
      nd.alive = i < c.n - c.n_crashed;
      nd.honest = i < c.n - c.n_crashed - c.n_byzantine;
      nd.proposal = i;  // proposal = '0'+m_id (paxos-node.cc:66)
      if (i < c.paxos_p) {
        nd.phase = 0;
        if (nd.alive) {
          // CLIENT_PROPOSE hook (paxos-node.cc:357-361): the client lane
          // starts when the simulated external client says so, not at t=0
          int64_t at = (i == c.paxos_client_node) ? c.paxos_client_ms : 0;
          sim.schedule_timer(i, T_START, at);  // paxos-node.cc:136-138
        }
      }
    }
  }

  bool clean() const { return sim.cfg.fidelity == 1; }

  void arm_window(Node& nd) {
    if (!clean()) return;  // the reference has no timeout — stalls are faithful
    nd.window_gen = sim.seq;
    int32_t jit = sim.rand_int(0, std::max(sim.cfg.paxos_timeout / 2, 1));
    sim.schedule_timer(nd.id, T_WINDOW, sim.now + sim.cfg.paxos_timeout + jit);
  }

  void require_ticket(Node& nd) {  // paxos-node.cc:511-518
    if (nd.ticket >= sim.cfg.paxos_max_ticket) {
      nd.gave_up = true;
      return;
    }
    nd.ticket++;
    nd.phase = 0;
    nd.vote_success = nd.vote_failed = 0;
    nd.adopt_t = -1;
    nd.adopt_cmd = -1;
    if (clean()) {  // self-promise (real Paxos; upstream gets this via echo)
      if (nd.ticket > nd.t_max) {
        if (nd.command >= 0 && nd.t_store > nd.adopt_t) {
          nd.adopt_t = nd.t_store;
          nd.adopt_cmd = nd.command;
        }
        nd.t_max = nd.ticket;
        nd.vote_success = 1;
      } else {
        nd.vote_failed = 1;
      }
    }
    sim.bcast(nd.id, Msg{REQUEST_TICKET, nd.id, nd.ticket, 0, 0},
              /*skip_first_peer=*/!clean());
    arm_window(nd);
  }

  void send_propose(Node& nd) {
    nd.phase = 1;
    nd.vote_success = nd.vote_failed = 0;
    if (nd.adopt_cmd >= 0) nd.proposal = nd.adopt_cmd;  // adoption
    if (clean()) {  // self-accept
      if (nd.ticket == nd.t_max) {
        nd.command = nd.proposal;
        nd.t_store = nd.ticket;
        nd.vote_success = 1;
      } else {
        nd.vote_failed = 1;
      }
    }
    sim.bcast(nd.id, Msg{REQUEST_PROPOSE, nd.id, nd.ticket, nd.proposal, 0},
              !clean());
    arm_window(nd);
  }

  void send_commit(Node& nd) {
    nd.phase = 2;
    nd.vote_success = nd.vote_failed = 0;
    if (clean()) {  // self-execute
      if (nd.ticket == nd.t_store && nd.proposal == nd.command) {
        if (nd.exec_tick < 0) nd.exec_tick = static_cast<int32_t>(sim.now);
        nd.is_commit = true;
        nd.vote_success = 1;
      } else {
        nd.vote_failed = 1;
      }
    }
    sim.bcast(nd.id, Msg{REQUEST_COMMIT, nd.id, nd.ticket, nd.proposal, 0},
              !clean());
    arm_window(nd);
  }

  void on_timer(Node& nd, int32_t timer, int64_t gen) {
    if (!nd.alive) return;
    if (timer == T_START) {
      require_ticket(nd);
    } else if (timer == T_WINDOW) {
      // clean-fidelity retry: window unresolved at its (jittered) deadline
      if (gen < nd.window_gen || nd.phase < 0 || nd.phase > 2) return;
      require_ticket(nd);
    }
  }

  // proposer-side shared counting + action selection.  In the reference the
  // window closes at exactly vote_success + vote_failed == N-2
  // (paxos-node.cc:258,295,332) and the *closing reply's type* picks the
  // action — counters are literally shared across phases.  Serial event
  // dispatch makes the == check exact here (the JAX twin quantizes to ticks
  // and uses a crossing check — documented divergence).
  void count_response(Node& nd, int32_t rtype, bool ok, int32_t prom_t, int32_t prom_cmd) {
    const SimCfg& c = sim.cfg;
    if (nd.gave_up || nd.id >= c.paxos_p) return;
    if (clean()) {
      // per-phase counting: only the current phase's reply type counts
      if (nd.phase < 0 || nd.phase > 2 || rtype != nd.phase) return;
      if (ok) {
        nd.vote_success++;
        if (rtype == 0 && prom_cmd >= 0 && prom_t > nd.adopt_t) {
          nd.adopt_t = prom_t;
          nd.adopt_cmd = prom_cmd;
        }
      } else {
        nd.vote_failed++;
      }
      int32_t majority = c.n / 2 + 1;
      if (nd.vote_success >= majority) {
        if (nd.phase == 0) send_propose(nd);
        else if (nd.phase == 1) send_commit(nd);
        else {  // CLIENT COMMIT SUCCESS (paxos-node.cc:339)
          if (nd.commit_tick < 0) nd.commit_tick = static_cast<int32_t>(sim.now);
          nd.phase = 3;
        }
      }
      // failures only resolve via the window timeout (temporal separation
      // keeps stale replies out of fresh windows — mirrors models/paxos.py)
    } else {
      if (ok) {
        nd.vote_success++;
        // reference adoption: the closing reply's command byte
        // (paxos-node.cc:264-266); track the latest non-empty SUCCESS command
        if (rtype == 0 && prom_cmd >= 0) nd.adopt_cmd = prom_cmd;
      } else {
        nd.vote_failed++;
      }
      if (nd.vote_success + nd.vote_failed == c.n - 2) {
        bool success = nd.vote_success >= c.n / 2;
        nd.vote_success = nd.vote_failed = 0;
        if (success) {
          if (rtype == 0) {
            if (nd.adopt_cmd >= 0) nd.proposal = nd.adopt_cmd;
            nd.phase = 1;
            sim.bcast(nd.id, Msg{REQUEST_PROPOSE, nd.id, nd.ticket, nd.proposal, 0}, true);
          } else if (rtype == 1) {
            nd.phase = 2;
            sim.bcast(nd.id, Msg{REQUEST_COMMIT, nd.id, nd.ticket, nd.proposal, 0}, true);
          } else {
            if (nd.commit_tick < 0) nd.commit_tick = static_cast<int32_t>(sim.now);
            nd.phase = 3;
          }
        } else {
          nd.adopt_cmd = -1;
          require_ticket(nd);
        }
      }
    }
  }

  void on_msg(Node& nd, const Msg& m) {
    switch (m.type) {
      case REQUEST_TICKET: {  // paxos-node.cc:177-197
        bool ok = m.a > nd.t_max;
        int32_t pt = nd.t_store, pc = nd.command;
        if (ok) nd.t_max = m.a;
        bool wire = nd.honest ? ok : !ok;
        sim.send(m.from, Msg{RESPONSE_TICKET, nd.id, wire ? 1 : 0,
                             (wire && nd.honest) ? pt : -1,
                             (wire && nd.honest) ? pc : -1});
        break;
      }
      case REQUEST_PROPOSE: {  // paxos-node.cc:199-221
        bool ok = m.a == nd.t_max;
        if (ok) {
          nd.command = m.b;
          nd.t_store = m.a;
        }
        bool wire = nd.honest ? ok : !ok;
        sim.send(m.from, Msg{RESPONSE_PROPOSE, nd.id, wire ? 1 : 0, -1, -1});
        break;
      }
      case REQUEST_COMMIT: {  // paxos-node.cc:222-247
        bool ok = (m.a == nd.t_store) && (m.b == nd.command);
        if (ok) {
          if (nd.exec_tick < 0) nd.exec_tick = static_cast<int32_t>(sim.now);
          nd.is_commit = true;
        }
        bool wire = nd.honest ? ok : !ok;
        sim.send(m.from, Msg{RESPONSE_COMMIT, nd.id, wire ? 1 : 0, -1, -1});
        break;
      }
      case RESPONSE_TICKET:
        count_response(nd, 0, m.a != 0, m.b, m.c);
        break;
      case RESPONSE_PROPOSE:
        count_response(nd, 1, m.a != 0, -1, -1);
        break;
      case RESPONSE_COMMIT:
        count_response(nd, 2, m.a != 0, -1, -1);
        break;
    }
  }
};
}  // namespace paxos

// ---------------------------------------------------------------------------
// run loop + metrics JSON
// ---------------------------------------------------------------------------
template <typename E>
void run_loop(E& eng) {
  Sim& sim = eng.sim;
  int64_t horizon = sim.cfg.sim_ms;
  while (!sim.q.empty()) {
    Event ev = sim.q.top();
    sim.q.pop();
    if (ev.t >= horizon) break;  // apps stop at the window end
    sim.now = ev.t;
    if (ev.kind == 2) {
      // link reservation is sender-side: it happens even when the receiver
      // is crashed (the packet still occupies the pipe in ns-3)
      sim.link_enqueue(ev.node, ev.msg);
      continue;
    }
    auto& nd = eng.nodes[ev.node];
    if (!nd.alive) continue;  // crashed nodes process nothing
    if (ev.kind == 1) {
      // timer events carry their scheduling seq as the cancellation token
      eng.on_timer(nd, ev.timer, ev.seq);
    } else {
      sim.delivered++;
      if (sim.cfg.echo && ev.msg.refl == 0) {
        // quirk #1 (bounded): reflect the packet to its sender once; the
        // reflected copy arrives as a normal message "from" the reflector
        // (the upstream replies to the socket's from-address) and is never
        // itself reflected, so the queue still drains.  The reflection
        // retransmits the FULL packet, so it keeps the original's
        // serialization time (an echoed 50 KB block is still 50 KB)
        Msg r = ev.msg;
        r.from = ev.node;
        r.refl = 1;
        sim.send(ev.msg.from, r, ev.msg.ser);
      }
      eng.on_msg(nd, ev.msg);
    }
  }
}

std::string json_pbft(pbft::Engine& eng) {
  const SimCfg& c = eng.sim.cfg;
  int32_t rounds = 0, bn_max = 0, vcs = 0, lead_rounds = 0;
  for (auto& nd : eng.nodes) {
    rounds = std::max(rounds, nd.next_n);
    bn_max = std::max(bn_max, nd.block_num);
    lead_rounds = std::max(lead_rounds, nd.rounds_sent);
    vcs += nd.view_changes;
  }
  int32_t final_all = 0;
  double ttf_sum = 0;
  int32_t last = -1;
  for (int32_t s = 0; s < std::min(rounds, c.pbft_slots); ++s) {
    bool all = true;
    int32_t mx = -1;
    for (auto& nd : eng.nodes)
      if (nd.alive) {
        all = all && nd.committed[s];
        mx = std::max(mx, nd.commit_tick[s]);
      }
    if (all && eng.propose_tick[s] >= 0) {
      final_all++;
      ttf_sum += mx - eng.propose_tick[s];
      last = std::max(last, mx);
    }
  }
  // agreement: committed slots hold one value across nodes that stored one
  bool agree = true;
  for (int32_t s = 0; s < std::min(rounds, c.pbft_slots); ++s) {
    int32_t val = -1;
    for (auto& nd : eng.nodes) {
      if (!nd.alive || !nd.committed[s] || nd.tx_val[s] < 0) continue;
      if (val < 0) val = nd.tx_val[s];
      else if (val != nd.tx_val[s]) agree = false;
    }
  }
  char buf[512];
  std::snprintf(
      buf, sizeof(buf),
      "{\"protocol\": \"pbft\", \"n\": %d, \"rounds_sent\": %d, "
      "\"leader_rounds_max\": %d, \"blocks_final_all_nodes\": %d, "
      "\"block_num_max\": %d, \"view_changes\": %d, \"last_commit_ms\": %.1f, "
      "\"mean_time_to_finality_ms\": %.6g, \"delivered_msgs\": %lld, "
      "\"agreement_ok\": %s}",
      c.n, rounds, lead_rounds, final_all, bn_max, vcs,
      static_cast<double>(last), final_all ? ttf_sum / final_all : -1.0,
      static_cast<long long>(eng.sim.delivered), agree ? "true" : "false");
  return buf;
}

std::string json_raft(raft::Engine& eng) {
  const SimCfg& c = eng.sim.cfg;
  int32_t lead = -1, n_leaders = 0, elections = 0, rounds = 0;
  for (auto& nd : eng.nodes) {
    elections += nd.elections;
    rounds = std::max(rounds, nd.round);
    if (nd.is_leader && nd.alive) {
      n_leaders++;
      if (lead < 0 || nd.leader_tick < eng.nodes[lead].leader_tick) lead = nd.id;
    }
  }
  int32_t blocks = lead >= 0 ? eng.nodes[lead].block_num : 0;
  double last_block = -1, mean_int = -1;
  if (lead >= 0 && blocks > 0) {
    auto& bt = eng.nodes[lead].block_tick;
    last_block = bt[blocks - 1];
    if (blocks > 1) mean_int = double(bt[blocks - 1] - bt[0]) / (blocks - 1);
  }
  bool agree = true;
  if (lead >= 0)
    for (auto& nd : eng.nodes)
      if (nd.alive && nd.m_value >= 0 && nd.m_value != lead) agree = false;
  char buf[512];
  std::snprintf(
      buf, sizeof(buf),
      "{\"protocol\": \"raft\", \"n\": %d, \"n_leaders\": %d, \"leader\": %d, "
      "\"leader_elected_ms\": %.1f, \"blocks\": %d, \"rounds\": %d, "
      "\"elections\": %d, \"last_block_ms\": %.1f, "
      "\"mean_block_interval_ms\": %.6g, \"delivered_msgs\": %lld, "
      "\"agreement_ok\": %s}",
      c.n, n_leaders, lead,
      lead >= 0 ? double(eng.nodes[lead].leader_tick) : -1.0, blocks, rounds,
      elections, last_block, mean_int,
      static_cast<long long>(eng.sim.delivered), agree ? "true" : "false");
  return buf;
}

std::string json_paxos(paxos::Engine& eng) {
  const SimCfg& c = eng.sim.cfg;
  int32_t winner = -1, n_committed = 0, max_ticket = 0, retries = 0, gave_up = 0;
  for (int32_t i = 0; i < c.paxos_p; ++i) {
    auto& nd = eng.nodes[i];
    if (nd.commit_tick >= 0) {
      n_committed++;
      if (winner < 0 || nd.commit_tick < eng.nodes[winner].commit_tick) winner = i;
    }
    max_ticket = std::max(max_ticket, nd.ticket);
    retries += std::max(nd.ticket - 1, 0);
    gave_up += nd.gave_up ? 1 : 0;
  }
  int32_t executes = 0, decided = -1, first_exec = -1;
  bool agree = true;
  for (auto& nd : eng.nodes) {
    if (!nd.alive || !nd.is_commit) continue;
    executes++;
    if (first_exec < 0 || nd.exec_tick < first_exec) first_exec = nd.exec_tick;
    if (decided < 0) decided = nd.command;
    else if (decided != nd.command) agree = false;
  }
  for (int32_t i = 0; i < c.paxos_p; ++i)
    if (eng.nodes[i].commit_tick >= 0 && decided >= 0 &&
        eng.nodes[i].proposal != decided)
      agree = false;
  char buf[512];
  std::snprintf(
      buf, sizeof(buf),
      "{\"protocol\": \"paxos\", \"n\": %d, \"n_committed_proposers\": %d, "
      "\"winner\": %d, \"winner_commit_ms\": %.1f, \"winner_ticket\": %d, "
      "\"max_ticket\": %d, \"retries\": %d, \"acceptor_executes\": %d, "
      "\"first_execute_ms\": %.1f, \"decided_command\": %d, \"gave_up\": %d, "
      "\"delivered_msgs\": %lld, \"agreement_ok\": %s}",
      c.n, n_committed, winner,
      winner >= 0 ? double(eng.nodes[winner].commit_tick) : -1.0,
      winner >= 0 ? eng.nodes[winner].ticket : -1, max_ticket, retries,
      executes, double(first_exec), decided, gave_up,
      static_cast<long long>(eng.sim.delivered), agree ? "true" : "false");
  return buf;
}

}  // namespace

extern "C" int run_sim(const SimCfg* cfg, char* out, int out_cap) {
  if (!cfg || !out || out_cap <= 0) return -1;
  if (cfg->n < 1 || cfg->sim_ms < 0 || cfg->paxos_p < 0 || cfg->paxos_p > cfg->n ||
      cfg->n_crashed < 0 || cfg->n_crashed > cfg->n || cfg->pbft_slots < 1)
    return -4;  // SimConfig validates these Python-side; belt and braces
  std::string s;
  if (cfg->protocol == 0) {
    pbft::Engine eng(*cfg);
    run_loop(eng);
    s = json_pbft(eng);
  } else if (cfg->protocol == 1) {
    raft::Engine eng(*cfg);
    run_loop(eng);
    s = json_raft(eng);
  } else if (cfg->protocol == 2) {
    paxos::Engine eng(*cfg);
    run_loop(eng);
    s = json_paxos(eng);
  } else {
    return -2;
  }
  if (static_cast<int>(s.size()) + 1 > out_cap) return -3;
  std::memcpy(out, s.c_str(), s.size() + 1);
  return 0;
}
