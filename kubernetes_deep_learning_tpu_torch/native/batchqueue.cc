// kdlt batch queue: native C++ request coalescing for the model server.
//
// The PyTorch port's own copy of the JAX package's native/batchqueue.cc.
// The Python DynamicBatcher (runtime/batcher.py) implements the policy; this
// is its native variant: submit/wait and batch assembly run entirely outside
// the GIL, so request threads block in C (no Python condvar wakeups on the
// hot path), the linger timer is immune to GIL contention jitter, and the
// gather of N request images into one contiguous batch buffer is a C++
// memcpy loop rather than np.stack under the GIL.  On the card the batch
// buffer is a pinned staging slot the engine lends, so each image is copied
// once on the host before its H2D copy.
//
// One addition to the JAX copy: besides the slot capacity (queued +
// in flight + awaiting collection), a cap on the QUEUED requests
// (kdlt_bq_set_max_pending), which is the Python batcher's queue_cap.
//
// Lifecycle of one request (ticket = slot index + generation):
//   submit():  free slot -> copy image into the slot -> PENDING, wake taker
//   take():    dispatcher pops <=max_batch PENDING (lingering up to
//              max_delay when the batch is small), copies slots into the
//              caller's batch buffer OUTSIDE the lock -> INFLIGHT
//   complete():writes each row of logits into its slot -> DONE, broadcast
//   wait():    request thread wakes, copies its row out, frees the slot
// Waiters that time out mark the slot abandoned; whichever of take/complete
// sees the flag reclaims the slot, so stragglers never leak capacity.
//
// Build: g++ at first use (ops/_native.py), into a library named by a hash
// of this source.  Python binding: runtime/native_batcher.py via ctypes
// (ctypes releases the GIL around every call).

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

enum class SlotState : uint8_t { kFree, kPending, kInflight, kDone, kFailed };

struct Slot {
  SlotState state = SlotState::kFree;
  bool abandoned = false;
  uint64_t gen = 0;
  std::vector<uint8_t> image;
  std::vector<float> out;
};

struct BatchQueue {
  std::mutex mu;
  std::condition_variable cv_work;   // submit -> take
  std::condition_variable cv_done;   // complete/fail/close -> wait
  std::condition_variable cv_drain;  // wait/take exit -> destroy
  std::vector<Slot> slots;
  std::deque<int> pending;           // slot indices in arrival order
  std::deque<int> free_slots;
  int64_t item_bytes;
  int out_floats;
  size_t max_pending;                // queued requests beyond this: full
  int active = 0;                    // threads inside wait()/take()
  bool closed = false;

  BatchQueue(int capacity, int64_t item_bytes_, int out_floats_)
      : slots(capacity), item_bytes(item_bytes_), out_floats(out_floats_),
        max_pending(capacity) {
    for (int i = 0; i < capacity; ++i) {
      // Image buffers are allocated lazily on first use (submit): eagerly
      // sizing capacity x item_bytes would pin ~550 MB for a 2048-deep
      // 299x299x3 queue, where actual residency only needs the high-water
      // mark of concurrent requests.  The tiny logits row is eager.
      slots[i].out.resize(out_floats);
      free_slots.push_back(i);
    }
  }
};

inline int64_t ticket_of(const BatchQueue& q, int slot, uint64_t gen) {
  return static_cast<int64_t>(gen) * static_cast<int64_t>(q.slots.size()) +
         slot;
}

inline void split_ticket(const BatchQueue& q, int64_t ticket, int* slot,
                         uint64_t* gen) {
  *slot = static_cast<int>(ticket % static_cast<int64_t>(q.slots.size()));
  *gen = static_cast<uint64_t>(ticket / static_cast<int64_t>(q.slots.size()));
}

void free_slot_locked(BatchQueue* q, int idx) {
  Slot& s = q->slots[idx];
  s.state = SlotState::kFree;
  s.abandoned = false;
  s.gen++;  // invalidates any stale ticket for this slot
  q->free_slots.push_back(idx);
}

// RAII guard for the active-call count destroy() drains on.
struct ActiveGuard {
  BatchQueue* q;
  explicit ActiveGuard(BatchQueue* q_, std::unique_lock<std::mutex>& lk)
      : q(q_) {
    (void)lk;  // caller must hold q->mu
    q->active++;
  }
  void release(std::unique_lock<std::mutex>& lk) {
    (void)lk;
    if (q) {
      q->active--;
      if (q->active == 0) q->cv_drain.notify_all();
      q = nullptr;
    }
  }
};

}  // namespace

extern "C" {

// capacity: max queued+in-flight requests; item_bytes: one image;
// out_floats: one logits row.
void* kdlt_bq_create(int capacity, int64_t item_bytes, int out_floats) {
  if (capacity <= 0 || item_bytes <= 0 || out_floats <= 0) return nullptr;
  return new BatchQueue(capacity, item_bytes, out_floats);
}

// Safe teardown: closes the queue, fails every unresolved slot (after
// destroy no dispatcher will ever complete them -- without this, stranded
// waiters would pin destroy until their own timeouts), then blocks until
// every thread inside wait()/take() has left before freeing.
void kdlt_bq_destroy(void* handle) {
  auto* q = static_cast<BatchQueue*>(handle);
  {
    std::unique_lock<std::mutex> lk(q->mu);
    q->closed = true;
    for (auto& s : q->slots) {
      if (s.state == SlotState::kPending || s.state == SlotState::kInflight)
        s.state = SlotState::kFailed;
    }
    q->pending.clear();
    q->cv_work.notify_all();
    q->cv_done.notify_all();
    q->cv_drain.wait(lk, [&] { return q->active == 0; });
  }
  delete q;
}

// Returns a ticket (>=0), -1 when full (retryable), -2 when closed.
int64_t kdlt_bq_submit(void* handle, const uint8_t* image) {
  auto* q = static_cast<BatchQueue*>(handle);
  int idx;
  uint64_t gen;
  {
    std::unique_lock<std::mutex> lk(q->mu);
    if (q->closed) return -2;
    if (q->free_slots.empty() || q->pending.size() >= q->max_pending) return -1;
    idx = q->free_slots.front();
    q->free_slots.pop_front();
    gen = q->slots[idx].gen;
    // Copy under the lock: the slot buffer is exclusively ours once popped,
    // but the pending publish must not precede the copy.  Unlock-copy-relock
    // would also be correct; a ~270 KB memcpy is cheap enough to keep simple.
    if (q->slots[idx].image.size() < static_cast<size_t>(q->item_bytes))
      q->slots[idx].image.resize(q->item_bytes);  // lazy, kept thereafter
    std::memcpy(q->slots[idx].image.data(), image, q->item_bytes);
    q->slots[idx].state = SlotState::kPending;
    q->pending.push_back(idx);
  }
  q->cv_work.notify_one();
  return ticket_of(*q, idx, gen);
}

// Dispatcher side.  Waits for work (forever when wait_s < 0, else up to
// wait_s -- the bounded mode lets a pipelining dispatcher come back to sync
// an in-flight batch instead of blocking on an idle queue); lingers up to
// max_delay_s while the batch is smaller than max_batch; then copies the
// taken images into dst (contiguous, arrival order) and writes their
// tickets.  Returns the batch size, 0 when the queue is closed and drained
// (the dispatcher should exit), or -1 when wait_s expired with no work.
int kdlt_bq_take(void* handle, uint8_t* dst, int max_batch,
                 double max_delay_s, double wait_s, int64_t* tickets) {
  auto* q = static_cast<BatchQueue*>(handle);
  std::vector<int> taken;
  std::unique_lock<std::mutex> lk(q->mu);
  ActiveGuard guard(q, lk);
  auto work_ready = [&] { return q->closed || !q->pending.empty(); };
  auto wait_deadline =
      wait_s < 0 ? Clock::time_point::max()
                 : Clock::now() + std::chrono::duration_cast<Clock::duration>(
                                      std::chrono::duration<double>(wait_s));
  // Outer loop: a round may pop only abandoned slots (every queued waiter
  // timed out while the engine was stuck on the previous batch).  That must
  // NOT return 0 -- 0 is the dispatcher-exit sentinel, and exiting on an
  // open queue would leave the model silently dead -- so go back to waiting.
  while (taken.empty()) {
    if (wait_s < 0) {
      q->cv_work.wait(lk, work_ready);
    } else if (!q->cv_work.wait_until(lk, wait_deadline, work_ready)) {
      guard.release(lk);
      return -1;  // bounded wait expired with no work
    }
    if (q->pending.empty()) {  // closed and drained
      guard.release(lk);
      return 0;
    }
    if (static_cast<int>(q->pending.size()) < max_batch && max_delay_s > 0) {
      auto deadline =
          Clock::now() + std::chrono::duration_cast<Clock::duration>(
                             std::chrono::duration<double>(max_delay_s));
      while (static_cast<int>(q->pending.size()) < max_batch) {
        if (q->cv_work.wait_until(lk, deadline) == std::cv_status::timeout)
          break;
        if (q->closed) break;
      }
    }
    while (!q->pending.empty() && static_cast<int>(taken.size()) < max_batch) {
      int idx = q->pending.front();
      q->pending.pop_front();
      Slot& s = q->slots[idx];
      if (s.abandoned) {  // waiter gave up (timeout/close) while queued
        free_slot_locked(q, idx);
        continue;
      }
      if (s.state != SlotState::kPending) continue;  // defensive
      s.state = SlotState::kInflight;
      taken.push_back(idx);
    }
  }
  // Tickets are computed under the lock: gen is stable for slots this
  // thread just marked kInflight, but an abort() racing this point marks
  // them kFailed, and a waking waiter then frees them (gen++ under the
  // lock) -- reading gen after unlock would be an unsynchronized
  // read/write race with that increment.
  for (size_t i = 0; i < taken.size(); ++i)
    tickets[i] = ticket_of(*q, taken[i], q->slots[taken[i]].gen);
  // Assemble with the lock released: in-flight slots are owned by the
  // dispatcher, so a large batch gather never blocks submitters.  The
  // active guard (still held) keeps destroy() from freeing slots under us.
  // The unlocked image reads cannot race a writer: image bytes are written
  // only by submit(), which requires a free slot, and an inflight slot can
  // only become free via abort()/destroy() -- both of which also close the
  // queue, so no submit can follow.  (If the slot IS freed mid-gather, the
  // stale bytes are copied but complete() drops the row on gen mismatch.)
  lk.unlock();
  for (size_t i = 0; i < taken.size(); ++i) {
    std::memcpy(dst + static_cast<int64_t>(i) * q->item_bytes,
                q->slots[taken[i]].image.data(), q->item_bytes);
  }
  lk.lock();
  guard.release(lk);
  return static_cast<int>(taken.size());
}

// Publish one batch of results: logits is n x row_floats, row i belongs to
// tickets[i].  row_floats must equal out_floats from create.
void kdlt_bq_complete(void* handle, const int64_t* tickets, int n,
                      const float* logits, int row_floats) {
  auto* q = static_cast<BatchQueue*>(handle);
  std::unique_lock<std::mutex> lk(q->mu);
  for (int i = 0; i < n; ++i) {
    int idx;
    uint64_t gen;
    split_ticket(*q, tickets[i], &idx, &gen);
    Slot& s = q->slots[idx];
    if (s.gen != gen || s.state != SlotState::kInflight) continue;  // stale
    if (s.abandoned) {
      free_slot_locked(q, idx);
      continue;
    }
    std::memcpy(s.out.data(), logits + static_cast<int64_t>(i) * row_floats,
                sizeof(float) * std::min(row_floats, q->out_floats));
    s.state = SlotState::kDone;
  }
  lk.unlock();
  q->cv_done.notify_all();
}

// Fail every ticket in the batch (engine raised): waiters get rc=2.
void kdlt_bq_fail(void* handle, const int64_t* tickets, int n) {
  auto* q = static_cast<BatchQueue*>(handle);
  std::unique_lock<std::mutex> lk(q->mu);
  for (int i = 0; i < n; ++i) {
    int idx;
    uint64_t gen;
    split_ticket(*q, tickets[i], &idx, &gen);
    Slot& s = q->slots[idx];
    if (s.gen != gen || s.state != SlotState::kInflight) continue;
    if (s.abandoned) {
      free_slot_locked(q, idx);
      continue;
    }
    s.state = SlotState::kFailed;
  }
  lk.unlock();
  q->cv_done.notify_all();
}

// Request side: block until the ticket resolves.  0 = ok (row in out),
// 1 = timeout (slot marked abandoned; its capacity is reclaimed later),
// 2 = failed (engine error, or the queue was aborted/destroyed),
// 4 = stale ticket.  A drain-close keeps queued waiters waiting for their
// results rather than failing them.
int kdlt_bq_wait(void* handle, int64_t ticket, float* out, double timeout_s) {
  auto* q = static_cast<BatchQueue*>(handle);
  int idx;
  uint64_t gen;
  split_ticket(*q, ticket, &idx, &gen);
  auto deadline =
      Clock::now() + std::chrono::duration_cast<Clock::duration>(
                         std::chrono::duration<double>(timeout_s));
  std::unique_lock<std::mutex> lk(q->mu);
  ActiveGuard guard(q, lk);
  Slot& s = q->slots[idx];
  int rc;
  bool timed_out = false;
  for (;;) {
    // State checks come BEFORE the timeout verdict: a completion racing the
    // deadline (cv_status::timeout with the slot already kDone/kFailed)
    // must resolve normally -- abandoning a completed slot would leak it
    // forever, since take() only reclaims abandoned slots still pending.
    if (s.gen != gen) {
      rc = 4;
      break;
    }
    if (s.state == SlotState::kDone) {
      std::memcpy(out, s.out.data(), sizeof(float) * q->out_floats);
      free_slot_locked(q, idx);
      rc = 0;
      break;
    }
    if (s.state == SlotState::kFailed) {
      free_slot_locked(q, idx);
      rc = 2;
      break;
    }
    // NOTE deliberately no closed+kPending early-out: close() means DRAIN
    // (matching DynamicBatcher.close(drain=True)) -- the dispatcher keeps
    // taking until the queue is empty, so a queued waiter just keeps
    // waiting for its result; abort()/destroy() fail the slots instead,
    // which resolves waiters through the kFailed branch above.
    if (timed_out) {
      // Genuinely unresolved past the deadline: flag the slot so
      // take/complete reclaims it; the result (if any) is dropped.
      s.abandoned = true;
      rc = 1;
      break;
    }
    timed_out =
        q->cv_done.wait_until(lk, deadline) == std::cv_status::timeout;
  }
  guard.release(lk);
  return rc;
}

// Stop accepting work (drain-close): new submits return -2, but queued
// requests are still taken, completed, and delivered; the dispatcher's
// take() returns 0 once the queue is empty.  Use abort/destroy to fail
// unresolved requests instead.
void kdlt_bq_close(void* handle) {
  auto* q = static_cast<BatchQueue*>(handle);
  {
    std::unique_lock<std::mutex> lk(q->mu);
    q->closed = true;
  }
  q->cv_work.notify_all();
  q->cv_done.notify_all();
}

// Close AND fail everything unresolved immediately (close without drain):
// queued waiters wake with rc=2 instead of being served.  The queue stays
// allocated; call destroy after joining the dispatcher.
void kdlt_bq_abort(void* handle) {
  auto* q = static_cast<BatchQueue*>(handle);
  {
    std::unique_lock<std::mutex> lk(q->mu);
    q->closed = true;
    for (auto& s : q->slots) {
      if (s.state == SlotState::kPending || s.state == SlotState::kInflight)
        s.state = SlotState::kFailed;
    }
    q->pending.clear();
  }
  q->cv_work.notify_all();
  q->cv_done.notify_all();
}

// Cap the queued (not yet taken) requests at n: submits beyond it return -1.
void kdlt_bq_set_max_pending(void* handle, int n) {
  auto* q = static_cast<BatchQueue*>(handle);
  std::unique_lock<std::mutex> lk(q->mu);
  q->max_pending = n < 0 ? 0 : static_cast<size_t>(n);
}

// Introspection for tests/metrics: current pending depth.
int kdlt_bq_pending(void* handle) {
  auto* q = static_cast<BatchQueue*>(handle);
  std::unique_lock<std::mutex> lk(q->mu);
  return static_cast<int>(q->pending.size());
}

}  // extern "C"
